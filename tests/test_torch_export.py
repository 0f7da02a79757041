"""Export and visualisation of the PyTorch port vs the JAX package.

On the synthetic full TWH (62 bones, 6 channels each) and BEAT (76 joints)
skeletons of `tests/torch_port_utils.py`:

* `motion/gltf_export.py`: the GLB bytes equal the JAX exporter's; `read_glb`
  reads them back (one node per joint and End Site, the animation's channels).
* `cli/export_gltf.py`: GLB and player HTML files equal the JAX CLI's.
* `motion/viz.py`: `mocapplayer_buffer` and `print_skel` string-identical;
  the stick figures plot the same line data (matplotlib's Agg backend).
* `motion/mocap_player.py`: the player page string-identical.
"""
import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

from diffusestylegesture_tpu.cli import export_gltf as jcli  # noqa: E402
from diffusestylegesture_tpu.motion import gltf_export as jglb  # noqa: E402
from diffusestylegesture_tpu.motion import mocap_player as jplayer  # noqa: E402
from diffusestylegesture_tpu.motion import pipeline as JP  # noqa: E402
from diffusestylegesture_tpu.motion import viz as jviz  # noqa: E402
from diffusestylegesture_torch.cli import export_gltf as tcli  # noqa: E402
from diffusestylegesture_torch.motion import gltf_export as tglb  # noqa: E402
from diffusestylegesture_torch.motion import mocap_player as tplayer  # noqa: E402
from diffusestylegesture_torch.motion import pipeline as TP  # noqa: E402
from diffusestylegesture_torch.motion import viz as tviz  # noqa: E402

from torch_port_utils import synth_beat_full_bvh, synth_twh62_bvh  # noqa: E402

SKELETONS = {"twh62": lambda p: synth_twh62_bvh(p, T=20),
             "beat": lambda p: synth_beat_full_bvh(p, T=24)}


@pytest.fixture(params=sorted(SKELETONS))
def bvh(request, tmp_path):
    path = str(tmp_path / f"{request.param}.bvh")
    SKELETONS[request.param](path)
    return path


def test_glb_bytes_equal_jax(bvh, tmp_path):
    out_t = tglb.bvh_to_glb(bvh, str(tmp_path / "t.glb"))
    out_j = jglb.bvh_to_glb(bvh, str(tmp_path / "j.glb"))
    with open(out_t, "rb") as f, open(out_j, "rb") as g:
        assert f.read() == g.read()
    gltf, blob = tglb.read_glb(out_t)
    track = TP.parse_bvh(bvh)
    assert len(gltf["nodes"]) == len(track.names)
    rotated = sum(len(TP.joint_rot_order(track, n)) == 3 for n in track.names)
    assert len(gltf["animations"][0]["channels"]) >= rotated
    assert gltf["buffers"][0]["byteLength"] == len(blob)


def test_export_cli_equals_jax(bvh, tmp_path):
    wt = tcli.main([bvh, "--outdir", str(tmp_path / "t"), "--player"])
    wj = jcli.main([bvh, "--outdir", str(tmp_path / "j"), "--player"])
    assert [os.path.basename(p) for p in wt] == [os.path.basename(p) for p in wj]
    for a, b in zip(wt, wj):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), a
    with pytest.raises(SystemExit):
        tcli.main([bvh, "--no_glb"])


def test_player_buffer_skeleton_print_and_page_equal_jax(bvh, tmp_path):
    tpos = TP.MocapParameterizer("position").transform(TP.parse_bvh(bvh))
    jpos = JP.MocapParameterizer("position").transform(JP.parse_bvh(bvh))
    meta = np.linspace(0, 1, len(tpos.values))[:, None]
    assert tviz.mocapplayer_buffer(tpos, meta=meta, frame_time=0.05) == \
        jviz.mocapplayer_buffer(jpos, meta=meta, frame_time=0.05)
    assert tviz.print_skel(tpos) == jviz.print_skel(jpos)
    assert tplayer.render_player_html("start([], [], 1, 2, 3);", {"a": None}) == \
        jplayer.render_player_html("start([], [], 1, 2, 3);", {"a": None})
    a = tplayer.write_mocap_player_html(tpos, str(tmp_path / "t.html"), frame_time=0.05)
    b = jplayer.write_mocap_player_html(jpos, str(tmp_path / "j.html"), frame_time=0.05)
    assert open(a).read() == open(b).read()


def line_data(ax):
    return sorted(tuple(np.round(np.asarray(ln.get_data(orig=True), float).ravel(), 5))
                  for ln in ax.get_lines())


def test_stick_figures_plot_the_same_lines(tmp_path):
    import matplotlib.pyplot as plt

    path = str(tmp_path / "twh.bvh")
    synth_twh62_bvh(path, T=6)
    tpos = TP.MocapParameterizer("position").transform(TP.parse_bvh(path))
    jpos = JP.MocapParameterizer("position").transform(JP.parse_bvh(path))
    for draw in ("draw_stickfigure", "sketch_move"):
        kw = {"frame": 2} if draw == "draw_stickfigure" else {"ax": None}
        ta = getattr(tviz, draw)(tpos, **kw)
        ja = getattr(jviz, draw)(jpos, **kw)
        assert line_data(ta) == line_data(ja), draw
        plt.close("all")
    ta = tviz.draw_stickfigure3d(tpos, 3)
    ja = jviz.draw_stickfigure3d(jpos, 3)
    assert len(ta.get_lines()) == len(ja.get_lines()) == len(tpos.names) - 1
    for lt, lj in zip(ta.get_lines(), ja.get_lines()):
        np.testing.assert_array_equal(np.asarray(lt.get_data_3d()), np.asarray(lj.get_data_3d()))
    plt.close("all")
