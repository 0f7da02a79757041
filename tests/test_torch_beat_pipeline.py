"""The port's BEAT/TWH motion pipeline (`motion/pipeline.py`,
`motion/pipeline_extras.py`) against the JAX package's.

On `tests/test_pipeline.py::synth_beat_bvh` (a 7-joint BEAT chain),
`tests/test_pipeline_ext.py::synth_twh_bvh` (5 TWH bones) and two full
skeletons (`torch_port_utils.synth_twh62_bvh`, the 62 TWH bones, 744 wide;
`synth_beat_full_bvh`, Hips + the 74 BEAT target joints + one more, 684 wide),
each package parses the file itself (the JAX side with `DSG_TPU_NO_NATIVE=1`,
its Python parser) and applies its own transforms. Every array agrees within
1e-12, every structure (names, parents, offsets, channels, columns) exactly,
and each written BVH is the same text, byte for byte: parsing and writing,
every transform forward and inverse, `beat_features` / `twh_features` and
both exports with and without the savgol smoothing. Without smoothing,
features → BVH → features round-trips within 1e-4 for both datasets.
"""
import numpy as np
import pytest

from diffusestylegesture_tpu.motion import pipeline as JP
from diffusestylegesture_tpu.motion import pipeline_extras as JX
from diffusestylegesture_torch.motion import pipeline as TP
from diffusestylegesture_torch.motion import pipeline_extras as TX

from test_pipeline import synth_beat_bvh
from test_pipeline_ext import synth_twh_bvh
from torch_port_utils import synth_beat_full_bvh, synth_twh62_bvh

TOL = 1e-12
SYNTH = {"beat7": lambda p: synth_beat_bvh(p, T=61, fps=120, seed=1),
         "twh5": lambda p: synth_twh_bvh(p, T=40, seed=2),
         "twh62": lambda p: synth_twh62_bvh(p, T=45, seed=3),
         "beat76": lambda p: synth_beat_full_bvh(p, T=81, seed=4)}


@pytest.fixture(autouse=True)
def _python_parser(monkeypatch):
    monkeypatch.setenv("DSG_TPU_NO_NATIVE", "1")


@pytest.fixture(params=sorted(SYNTH))
def bvh(request, tmp_path):
    path = str(tmp_path / f"{request.param}.bvh")
    SYNTH[request.param](path)
    return request.param, path


def parsed(path):
    return TP.parse_bvh(path), JP.parse_bvh(path)


def assert_same(port, ref):
    """ChannelData (structure exact, values within TOL), arrays or lists of them."""
    if isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            assert_same(a, b)
        return
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray) and port.shape == ref.shape
        assert port.dtype == ref.dtype
        np.testing.assert_allclose(port, ref, rtol=0, atol=TOL)
        return
    assert isinstance(port, TP.ChannelData) and isinstance(ref, JP.ChannelData)
    assert port.names == ref.names and port.parents == ref.parents
    assert port.channels == ref.channels and port.columns == ref.columns
    assert port.root_name == ref.root_name and port.framerate == ref.framerate
    assert port.offsets.keys() == ref.offsets.keys()
    for k in ref.offsets:
        np.testing.assert_array_equal(port.offsets[k], ref.offsets[k])
    assert port.values.shape == ref.values.shape
    np.testing.assert_allclose(port.values, ref.values, rtol=0, atol=TOL)


def written(tmp_path, tag, port, ref):
    """The text each package writes for its own ChannelData."""
    a, b = str(tmp_path / f"{tag}_port.bvh"), str(tmp_path / f"{tag}_jax.bvh")
    TP.write_bvh_channels(port, a)
    JP.write_bvh_channels(ref, b)
    with open(a) as fa, open(b) as fb:
        return fa.read(), fb.read()


def test_parse_and_write(bvh, tmp_path):
    _, path = bvh
    port, ref = parsed(path)
    assert_same(port, ref)
    assert TP.parse_bvh is TP.parse_bvh_python
    text_p, text_j = written(tmp_path, "rw", port, ref)
    assert text_p == text_j
    with open(path) as f:
        assert f.read() == text_p  # the synthetic files were written by the JAX writer


def test_parse_inline_braces(tmp_path):
    path = str(tmp_path / "inline.bvh")
    with open(path, "w") as f:
        f.write("HIERARCHY\nROOT Hips {\n\tOFFSET 0 1 2\n\tCHANNELS 6 Xposition Yposition "
                "Zposition Zrotation Xrotation Yrotation\n\tJOINT Spine{\n\t\tOFFSET 1 0 0\n"
                "\t\tCHANNELS 3 Zrotation Xrotation Yrotation\n\t\tEnd Site {\n\t\t\tOFFSET 0 1 0"
                "\n\t\t}\n\t}\n}\nMOTION\nFrames: 2\nFrame Time: 0.0333333\n"
                "1 2 3 4 5 6 7 8 9\n9 8 7 6 5 4 3 2 1\n")
    assert_same(*parsed(path))


@pytest.mark.parametrize("which", ["beat", "twh"])
def test_features_and_exports(which, tmp_path):
    path = str(tmp_path / "clip.bvh")
    if which == "beat":
        synth_beat_full_bvh(path, T=121, seed=5)
        feats, back = (TP.beat_features, JP.beat_features), (TP.beat_features_to_bvh,
                                                              JP.beat_features_to_bvh)
        width = 684
    else:
        synth_twh62_bvh(path, T=60, seed=6)
        feats, back = (TP.twh_features, JP.twh_features), (TP.twh_features_to_bvh,
                                                          JP.twh_features_to_bvh)
        width = 744
    (fp, pipe_p), (fj, pipe_j) = feats[0](path), feats[1](path)
    assert fp.shape[1] == width and fp.dtype == np.float32
    assert_same(fp, fj)
    # a parse passed in gives what the path gives
    assert_same(feats[0](TP.parse_bvh(path))[0], fj)
    for smoothing in (True, False):
        a, b = str(tmp_path / f"p{smoothing}.bvh"), str(tmp_path / f"j{smoothing}.bvh")
        back[0](fp, pipe_p, a, smoothing=smoothing)
        back[1](fj, pipe_j, b, smoothing=smoothing)
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    # features → BVH → features without smoothing (BEAT: the re-parse at 30 fps
    # drops its last frame, the DownSampler's [0:-1:1])
    again, _ = feats[0](str(tmp_path / "pFalse.bvh"))
    np.testing.assert_allclose(again, fp[:len(again)], atol=1e-4)
    assert len(again) == len(fp) - (which == "beat")


def test_joint_selector_downsampler_numpyfier(bvh):
    name, path = bvh
    port, ref = parsed(path)
    joints = list(TP.TWH_BONE_NAMES if name.startswith("twh") else TP.BEAT_TARGET_JOINTS)
    for include_root in (False, True):
        for exact in (False, True):
            sp = TP.JointSelector(joints, include_root, exact).fit(port)
            sj = JP.JointSelector(joints, include_root, exact).fit(ref)
            assert sp.selected_channels == sj.selected_channels
            assert sp.not_selected_values == sj.not_selected_values
            out_p, out_j = sp.transform(port), sj.transform(ref)
            assert_same(out_p, out_j)
            assert_same(sp.inverse_transform(out_p), sj.inverse_transform(out_j))
    if name.startswith("beat"):
        dp, dj = TP.DownSampler(30), JP.DownSampler(30)
        assert_same(dp.fit(port).transform(port), dj.fit(ref).transform(ref))
        assert_same(TP.DownSampler(30, keep_all=True).transform_all(port),
                    JP.DownSampler(30, keep_all=True).transform_all(ref))
        assert_same(dp.inverse_transform(port), dj.inverse_transform(ref))
        with pytest.raises(ValueError, match="transform_all"):
            TP.DownSampler(30, keep_all=True).transform(port)
        with pytest.raises(ValueError, match="integer multiple"):
            TP.DownSampler(50).transform(port)
    npp, npj = TP.Numpyfier().fit(port), JP.Numpyfier().fit(ref)
    assert_same(npp.transform(port), npj.transform(ref))
    assert_same(npp.inverse_transform(port.values * 0.5), npj.inverse_transform(ref.values * 0.5))


def test_constants_removers_and_pipelines(bvh):
    _, path = bvh
    port, ref = parsed(path)
    for keep_root in (False, True):
        data_p, data_j = port.clone(), ref.clone()
        # make two channels constant so something is removed
        for d in (data_p, data_j):
            d.values[:, 1] = 3.25
            d.values[:, -1] = -1.5
        cp = TP.ConstantsRemover(keep_root=keep_root).fit(data_p)
        cj = JP.ConstantsRemover(keep_root=keep_root).fit(data_j)
        assert cp.const_cols == cj.const_cols and cp.const_values == cj.const_values
        out_p, out_j = cp.transform(data_p), cj.transform(data_j)
        assert_same(out_p, out_j)
        assert_same(cp.inverse_transform(out_p), cj.inverse_transform(out_j))
    root = port.root_name
    rp, rj = TP.ConstantsRemoverWithRoot(root).fit(port), JP.ConstantsRemoverWithRoot(root).fit(ref)
    assert rp.const_dims == rj.const_dims and rp.const_values == rj.const_values
    out_p, out_j = rp.transform(port), rj.transform(ref)
    assert_same(out_p, out_j)
    assert_same(rp.inverse_transform(out_p), rj.inverse_transform(out_j))
    pp = TP.MotionPipeline([TP.JointSelector(port.names[1:3], include_root=True), TP.Numpyfier()])
    pj = JP.MotionPipeline([JP.JointSelector(ref.names[1:3], include_root=True), JP.Numpyfier()])
    arr_p, arr_j = pp.fit_transform(port), pj.fit_transform(ref)
    assert_same(arr_p, arr_j)
    assert_same(pp.transform(port), pj.transform(ref))
    assert_same(pp.inverse_transform(arr_p + 1.0), pj.inverse_transform(arr_j + 1.0))


def test_mocap_parameterizer_and_expmap_pipeline(bvh, tmp_path):
    name, path = bvh
    port, ref = parsed(path)
    for kind in ("euler", "expmap", "position"):
        mp, mj = TP.MocapParameterizer(kind).fit(port), JP.MocapParameterizer(kind).fit(ref)
        out_p, out_j = mp.transform(port), mj.transform(ref)
        assert_same(out_p, out_j)
        if kind != "position":
            assert_same(mp.inverse_transform(out_p), mj.inverse_transform(out_j))
    with pytest.raises(ValueError, match="param_type"):
        TP.MocapParameterizer("quat")
    assert TP._pymo_traverse(port) == JP._pymo_traverse(ref)
    rots = np.random.default_rng(0).standard_normal((30, 3)) * 2.5
    assert_same(TP.fix_rotvec(rots), JP.fix_rotvec(rots))
    if name.startswith("twh"):
        (fp, pipe_p) = TP.twh_features_expmap(path)
        (fj, pipe_j) = JP.twh_features_expmap(path)
        assert_same(fp, fj)
        back_p = pipe_p.inverse_transform(fp.astype(np.float64))
        back_j = pipe_j.inverse_transform(fj.astype(np.float64))
        assert_same(back_p, back_j)
        text_p, text_j = written(tmp_path, "expmap", back_p, back_j)
        assert text_p == text_j


def test_mirror_root_normalizer_root_transformer(bvh):
    name, path = bvh
    port, ref = parsed(path)
    if name == "beat76":  # Left and Right joints on both sides
        for axis in "XYZ":
            assert_same(TP.mirror(port, axis), JP.mirror(ref, axis))
    assert_same(TP.root_normalizer(port), JP.root_normalizer(ref))
    for method in ("hip_centric", "abdolute_translation_deltas", "pos_rot_deltas"):
        for pos_s, rot_s in ((0, 0), (2.0, 1.5)):
            tp = TP.RootTransformer(method, pos_s, rot_s).fit(port)
            tj = JP.RootTransformer(method, pos_s, rot_s).fit(ref)
            out_p, out_j = tp.transform(port), tj.transform(ref)
            assert_same(out_p, out_j)
            assert_same(tp.inverse_transform(out_p, start_pos=(0.5, -1.0)),
                        tj.inverse_transform(out_j, start_pos=(0.5, -1.0)))
    with pytest.raises(ValueError, match="method"):
        TP.RootTransformer("pivot")


def test_pipeline_extras(bvh):
    _, path = bvh
    port, ref = parsed(path)
    tracks_p, tracks_j = [port, port.clone()], [ref, ref.clone()]
    for size, overlap in ((8, 0.5), (10, 0.25)):
        sp, sj = TX.Slicer(size, overlap).fit(tracks_p), JX.Slicer(size, overlap).fit(tracks_j)
        win_p, win_j = sp.transform(tracks_p), sj.transform(tracks_j)
        assert_same(win_p, win_j)
        assert_same(sp.inverse_transform(win_p), sj.inverse_transform(win_j))
    pos_p = TP.MocapParameterizer("position").transform(port)
    pos_j = JP.MocapParameterizer("position").transform(ref)
    rp, rj = TX.RootCentricPositionNormalizer().fit(pos_p), JX.RootCentricPositionNormalizer()
    out_p, out_j = rp.transform(pos_p), rj.fit(pos_j).transform(pos_j)
    assert_same(out_p, out_j)
    assert_same(rp.inverse_transform(out_p), rj.inverse_transform(out_j))
    arrays = [port.values, port.values[::2] * 0.5 + 1.0]
    assert_same(TX.Flattener().fit(arrays).transform(arrays),
                JX.Flattener().fit(arrays).transform(arrays))
    for cls_p, cls_j in ((TX.ListStandardScaler, JX.ListStandardScaler),
                         (TX.ListMinMaxScaler, JX.ListMinMaxScaler)):
        same_len = [port.values, port.values * 0.5 + 1.0]
        sp, sj = cls_p().fit(same_len), cls_j().fit(same_len)
        zp, zj = sp.transform(same_len), sj.transform(same_len)
        assert_same(zp, zj)
        assert_same(sp.inverse_transform(zp), sj.inverse_transform(zj))
    for append in (True, False):
        assert_same(TX.ReverseTime(append).fit(tracks_p).transform(tracks_p),
                    JX.ReverseTime(append).fit(tracks_j).transform(tracks_j))
    assert TX.TemplateTransform().fit(port).transform(port) is port
    cp, cj = TX.ConstantsRemoverAllPosRot().fit(tracks_p), JX.ConstantsRemoverAllPosRot()
    out_p, out_j = cp.transform(tracks_p), cj.fit(tracks_j).transform(tracks_j)
    assert cp.const_dims_ == cj.const_dims_ and cp.const_values_ == cj.const_values_
    assert_same(out_p, out_j)
    assert_same(cp.inverse_transform(out_p), cj.inverse_transform(out_j))
