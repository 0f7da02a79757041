"""The port's BEAT/TWH data modules against the JAX package's.

* `data/beat_twh.py`: `load_metadata` (both participants), `textgrid_to_tsv`
  on the long, short and header-less long TextGrid formats (first tier only;
  the tsv text identical), and `build_beat_twh_clip` for TWH and BEAT with
  injected WavLM features: gesture, text and speaker exact, the 109 host
  audio columns within 1e-6 (the port's numpy copies), the 1024 interpolated
  WavLM columns within 1e-6 plus one float32 ulp of the source position times
  the largest frame-to-frame step of the features (the two packages round
  some interpolation positions one ulp apart: 8.2e-5 here).
* `data/bvh_repair.py` and `data/beat_proc.py`: the same files written, the
  same arrays and dicts (exact); the HDF5 bundle IO reads what the other
  package wrote.
* `data/h5_loader.py`: the port's `.npz` store against a JAX-written `.h5` of
  the same clips: arrays exact, statistics within 1e-6; the port also reads
  the JAX `.h5` itself; `SpeechGestureDataset` on either gives the JAX
  loader's clips and, for one seed, its batches exactly, including the
  tile-padded short clip and the exclusive-high start. Without h5py a `.h5`
  raises a clear ImportError.
"""
import sys

import numpy as np
import pytest

from diffusestylegesture_tpu.data import beat_proc as JBP
from diffusestylegesture_tpu.data import beat_twh as JBT
from diffusestylegesture_tpu.data import bvh_repair as JBR
from diffusestylegesture_tpu.data import h5_loader as JH
from diffusestylegesture_torch.data import beat_proc as TBP
from diffusestylegesture_torch.data import beat_twh as TBT
from diffusestylegesture_torch.data import bvh_repair as TBR
from diffusestylegesture_torch.data import h5_loader as TH

from test_pipeline import synth_beat_bvh
from torch_port_utils import (interpolation_rounding_bar, synth_beat_full_bvh,
                              synth_twh62_bvh)

META = ("prefix,main-agent_id,main-agent_has_finger,interloctr_id,interloctr_has_finger\n"
        "trn_2023_v0_000,3,finger_incl,4,finger_incl\n"
        "trn_2023_v0_001,5,no_finger,3,finger_incl\n"
        "trn_2023_v0_002,3,finger_incl,7,no_finger\n")

LONG = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 2.5
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 2.5
        intervals: size = 3
        intervals [1]:
            xmin = 0
            xmax = 0.7
            text = "hello"
        intervals [2]:
            xmin = 0.7
            xmax = 1.1
            text = ""
        intervals [3]:
            xmin = 1.1
            xmax = 2.5
            text = "big world"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 2.5
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 2.5
            text = "HH"
'''
SHORT = '''File type = "ooTextFile"
Object class = "TextGrid"

0
2.5
<exists>
1
"IntervalTier"
"words"
0
2.5
3
0
0.7
"hello"
0.7
1.1
""
1.1
2.5
"big world"
'''
HEADERLESS = '''intervals [1]:
    xmin = 0.25
    xmax = 0.9
    text = "laugh#"
intervals [2]:
    xmin = 0.9
    xmax = 1.4
    text = "now"
'''


def test_load_metadata(tmp_path):
    path = tmp_path / "meta.csv"
    path.write_text(META)
    for participant in ("main-agent", "interloctr"):
        assert TBT.load_metadata(str(path), participant) == JBT.load_metadata(str(path),
                                                                            participant)
    assert TBT.load_metadata(str(path))[0] == 2
    with pytest.raises(ValueError, match="participant"):
        TBT.load_metadata(str(path), "audience")


@pytest.mark.parametrize("fmt", ["long", "short", "headerless"])
def test_textgrid_to_tsv(tmp_path, fmt):
    text = {"long": LONG, "short": SHORT, "headerless": HEADERLESS}[fmt]
    src = tmp_path / f"{fmt}.TextGrid"
    src.write_text(text)
    a = TBT.textgrid_to_tsv(str(src), str(tmp_path / "port.tsv"))
    b = JBT.textgrid_to_tsv(str(src), str(tmp_path / "jax.tsv"))
    with open(a) as fa, open(b) as fb:
        port, ref = fa.read(), fb.read()
    assert port == ref and port.count("\n") == 2  # the empty interval is dropped
    assert "HH" not in port  # the second tier never leaks in
    assert TBT.textgrid_to_tsv(str(src)) == str(src).replace(".TextGrid", ".tsv")
    bad = tmp_path / "bad.TextGrid"
    bad.write_text("nothing here\n")
    with pytest.raises(ValueError, match="unrecognized"):
        TBT.textgrid_to_tsv(str(bad))


def test_bvh_repair(tmp_path):
    path = str(tmp_path / "a.bvh")
    synth_beat_bvh(path, T=20)
    with open(path) as f:
        text = f.read()
    broken = text.replace("Frames: 20", "Frames: 23")
    for name in ("port", "jax"):
        (tmp_path / f"{name}.bvh").write_text(broken)
    assert TBR.fix_frame_count(str(tmp_path / "port.bvh")) == \
        JBR.fix_frame_count(str(tmp_path / "jax.bvh")) == (True, 20)
    assert (tmp_path / "port.bvh").read_text() == (tmp_path / "jax.bvh").read_text() == text
    assert TBR.fix_frame_count(path, write=False) == (False, 20)
    TBR.reorient_t_pose(path, str(tmp_path / "port_t.bvh"))
    JBR.reorient_t_pose(path, str(tmp_path / "jax_t.bvh"))
    assert (tmp_path / "port_t.bvh").read_text() == (tmp_path / "jax_t.bvh").read_text()
    (tmp_path / "none.bvh").write_text("HIERARCHY\n")
    with pytest.raises(ValueError, match="Frames"):
        TBR.fix_frame_count(str(tmp_path / "none.bvh"))


def _assert_dict_equal(a, b):
    assert a.keys() == b.keys()
    for k in b:
        if isinstance(b[k], dict):
            _assert_dict_equal(a[k], b[k])
        elif isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_beat_proc(tmp_path, monkeypatch):
    monkeypatch.setenv("DSG_TPU_NO_NATIVE", "1")
    path = str(tmp_path / "beat.bvh")
    synth_beat_full_bvh(path, T=25)
    for keep in (False, True):
        _assert_dict_equal(TBP.load_bvh_data(path, keep), JBP.load_bvh_data(path, keep))
    info = TBP.load_bvh_data(path)
    angles = info["rot_angles"]
    np.testing.assert_array_equal(TBP.euler2mat(angles, info["euler_orders"]),
                                  JBP.euler2mat(angles, info["euler_orders"]))
    with pytest.raises(ValueError, match="joint orders"):
        TBP.euler2mat(angles[:, :-1], info["euler_orders"])
    names = info["joint_names"]
    keep = [names[0], names[3], names[10], names[40]]
    sel_p = TBP.select_joints(keep, names, parents=info["parents"], offsets=info["offsets"],
                              motion=angles)
    sel_j = JBP.select_joints(keep, names, parents=info["parents"], offsets=info["offsets"],
                              motion=angles)
    for a, b in zip(sel_p, sel_j):
        np.testing.assert_array_equal(a, b)
    for with_endsite in (False, True):
        kw = dict(joint_names=names, skeleton_tree=info["parents"], offsets=info["offsets"],
                  euler_orders=info["euler_orders"], framerate=info["framerate"],
                  motion=angles, global_trans=info["global_pos"], with_endsite=with_endsite)
        TBP.write_bvh_data(str(tmp_path / "p.bvh"), **kw)
        JBP.write_bvh_data(str(tmp_path / "j.bvh"), **kw)
        assert (tmp_path / "p.bvh").read_text() == (tmp_path / "j.bvh").read_text()
    bundle = {"motion": angles.astype(np.float32), "names": ["a", "b"], "meta": {"fps": 30.0}}
    TBP.save_h5_dataset(str(tmp_path / "p.h5"), bundle)
    JBP.save_h5_dataset(str(tmp_path / "j.h5"), bundle)
    _assert_dict_equal(TBP.load_h5_dataset(str(tmp_path / "j.h5")),
                       JBP.load_h5_dataset(str(tmp_path / "p.h5")))


def _synth_clip(tmp_path, dataset, seed=0, seconds=3.0):
    """A BVH, a wav and a tsv for one clip, and fake (T', 1024) WavLM features."""
    rng = np.random.default_rng(seed)
    bvh = str(tmp_path / f"{dataset}{seed}.bvh")
    if dataset == "TWH":
        synth_twh62_bvh(bvh, T=int(seconds * 30) + 3, seed=seed)
    else:
        synth_beat_full_bvh(bvh, T=int(seconds * 120) + 9, seed=seed)
    t = np.arange(int(16000 * seconds)) / 16000
    wav = (0.3 * np.sin(2 * np.pi * (160 + 10 * seed) * t) * (1 + np.sin(2 * np.pi * 2 * t))
           + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    tsv = tmp_path / f"{dataset}{seed}.tsv"
    tsv.write_text("0.10\t0.55\thello\n0.60\t1.20\tbig world\n1.5\t2.0\t#laugh#\n")
    w2v = {w: rng.standard_normal(300) for w in ("hello", "world", "big")}
    wavlm = rng.standard_normal((int(seconds * 50) - 1, 1024)).astype(np.float32)
    return bvh, wav, str(tsv), w2v, wavlm


@pytest.mark.parametrize("dataset", ["TWH", "BEAT"])
def test_build_beat_twh_clip(tmp_path, monkeypatch, dataset):
    monkeypatch.setenv("DSG_TPU_NO_NATIVE", "1")
    bvh, wav, tsv, w2v, wavlm = _synth_clip(tmp_path, dataset)
    onehot = np.eye(17 if dataset == "TWH" else 2, dtype=np.float32)[1]
    timings = {}
    port = TBT.build_beat_twh_clip(bvh, wav, 16000, tsv, w2v, onehot, dataset=dataset,
                                   wavlm_features=wavlm, timings=timings)
    ref = JBT.build_beat_twh_clip(bvh, wav, 16000, tsv, w2v, onehot, dataset=dataset,
                                  wavlm_features=wavlm)
    assert port.keys() == ref.keys()
    widths = {"gesture": 744 if dataset == "TWH" else 684, "audio": 1133,
              "text": 302 if dataset == "TWH" else 301}
    for k in ("speaker_id", "gesture", "text"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    host = np.r_[0:108, 1132]  # MFCC, log-mel, prosody, onset: the port's numpy copies
    np.testing.assert_allclose(port["audio"][:, host], ref["audio"][:, host], rtol=0, atol=1e-6)
    # the 1024 WavLM columns, linearly interpolated from 149 rows to the clip's
    # frames: the port places row i at i·((T'−1)/(T−1)) in float32, XLA's
    # compiled jnp.linspace rounds some positions one ulp apart (ROADMAP §3)
    bar = 1e-6 + interpolation_rounding_bar(wavlm)
    np.testing.assert_allclose(port["audio"][:, 108:1132], ref["audio"][:, 108:1132], rtol=0,
                               atol=bar)
    for k, w in widths.items():
        assert port[k].shape == (len(port["gesture"]), w) and port[k].dtype == np.float32
    assert set(timings) == {"bvh_parse", "gesture", "audio_text"}
    with pytest.raises(ValueError, match="BEAT or TWH"):
        TBT.build_beat_twh_clip(bvh, wav, 16000, tsv, w2v, onehot, dataset="ZEGGS")


def _clips(n_frames=(180, 40, 151), seed=0):
    """Store dicts with seeded arrays; the second clip is shorter than 150
    frames and the third one frame longer: the tile pad and the exclusive
    high. Modalities of uneven length, cropped by the builder."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(n_frames):
        out.append({"speaker_id": np.eye(17, dtype=np.float32)[i + 2],
                    "gesture": rng.standard_normal((n + 2, 744)).astype(np.float32),
                    "audio": rng.standard_normal((n, 1133)).astype(np.float32),
                    "text": rng.standard_normal((n + 1, 302)).astype(np.float32)})
    return out


@pytest.fixture
def stores(tmp_path):
    clips = _clips()
    npz, h5 = str(tmp_path / "TWH.npz"), str(tmp_path / "TWH.h5")
    TH.build_h5_dataset(npz, clips)
    JH.build_h5_dataset(h5, clips)
    return npz, h5


def test_store_against_a_jax_written_h5(stores, tmp_path):
    npz, h5 = stores
    port, ref = TH.read_store(npz), TH.read_store(h5)
    assert sorted(port) == sorted(ref) == ["0", "1", "2"]
    for k in ref:
        for f in TH.FIELDS:
            assert port[k][f].dtype == ref[k][f].dtype
            np.testing.assert_array_equal(port[k][f], ref[k][f], err_msg=f"{k}/{f}")
    assert len(port["0"]["gesture"]) == len(port["0"]["audio"]) == 180
    for path in (npz, h5):
        mean, std = TH.gesture_statistics(path)
        jmean, jstd = JH.gesture_statistics(h5)
        np.testing.assert_allclose(mean, jmean, rtol=0, atol=1e-6)
        np.testing.assert_allclose(std, jstd, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="npz"):
        TH.build_h5_dataset(str(tmp_path / "x.h5"), _clips())
    with pytest.raises(ValueError, match="npz"):
        TH.read_store(str(tmp_path / "x.lmdb"))


def test_h5_needs_h5py(stores, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        TH.read_store(stores[1])
    TH.read_store(stores[0])  # the port's own store needs no h5py


def test_speech_gesture_dataset_matches_jax(stores):
    npz, h5 = stores
    mean, std = JH.gesture_statistics(h5)
    ref = JH.SpeechGestureDataset(h5, mean, std, n_poses=150)
    for path in (npz, h5):
        port = TH.SpeechGestureDataset(path, mean, std, n_poses=150)
        assert len(port) == len(ref) == 3
        for a, b in ((port.gesture, ref.gesture), (port.textaudio, ref.textaudio),
                     (port.speaker, ref.speaker)):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.float32
                np.testing.assert_array_equal(x, y)
        assert port.gesture[0].shape == (180, 3 * 744)
        for bp, bj in zip(port.batches(8, seed=3, num_batches=4),
                          ref.batches(8, seed=3, num_batches=4)):
            assert bp.keys() == bj.keys() == {"audio", "motion", "style"}
            for k in bj:
                np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)
        assert bp["motion"].shape == (8, 150, 2232) and bp["audio"].shape == (8, 150, 1435)


def test_speech_gesture_dataset_short_clip_and_exclusive_high(stores):
    npz, _ = stores
    mean, std = TH.gesture_statistics(npz)
    ds = TH.SpeechGestureDataset(npz, mean, std, n_poses=150)
    rng = np.random.default_rng(0)
    a, g, s = ds.sample(rng, 1)  # 40 frames, tiled to 150
    assert g.shape == (150, 2232) and a.shape == (150, 1435)
    np.testing.assert_array_equal(g, np.tile(ds.gesture[1], (4, 1))[:150])
    for _ in range(20):  # 151 frames: the only start drawn is 0, the last frame never
        a, g, s = ds.sample(rng, 2)
        np.testing.assert_array_equal(g, ds.gesture[2][:150])
    np.testing.assert_array_equal(s, np.eye(17, dtype=np.float32)[4])
