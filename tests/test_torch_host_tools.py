"""The port's host tools against their JAX twins, on the same inputs:
``data/generic_io`` (raw and HTK files, ``GenericDataset``,
``ConcatDataset``, collation), ``utils/stats``, ``utils/filelists``,
``utils/text``, ``utils/warehouse``, ``utils/probe``,
``train/schedulers``, ``train/monitor`` and ``train/logs``.

Tolerances: exact for indices, tokens, strings and the bytes of written
files; float64 numpy outputs within 1e-12 (the same numpy code, which sums
in the same order: they are equal in fact); float32 dataset items exact.
``.npz`` files carry a timestamp per entry, so those are held key for key
and array for array."""

import json
import os

import numpy as np
import pytest
import torch

from scl_deepfake_audio_detection_tpu.data import generic_io as JG
from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.models.linear_nll import LinearNLL as JLinearNLL
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_tpu.train import logs as JL
from scl_deepfake_audio_detection_tpu.train import monitor as JM
from scl_deepfake_audio_detection_tpu.train import schedulers as JS
from scl_deepfake_audio_detection_tpu.utils import filelists as JF
from scl_deepfake_audio_detection_tpu.utils import probe as JP
from scl_deepfake_audio_detection_tpu.utils import stats as JST
from scl_deepfake_audio_detection_tpu.utils import text as JT
from scl_deepfake_audio_detection_tpu.utils import warehouse as JW
from scl_deepfake_audio_detection_torch.data import generic_io as PG
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import load_jax_params
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train import logs as PL
from scl_deepfake_audio_detection_torch.train import monitor as PM
from scl_deepfake_audio_detection_torch.train import schedulers as PS
from scl_deepfake_audio_detection_torch.utils import filelists as PF
from scl_deepfake_audio_detection_torch.utils import probe as PP
from scl_deepfake_audio_detection_torch.utils import stats as PST
from scl_deepfake_audio_detection_torch.utils import text as PT
from scl_deepfake_audio_detection_torch.utils import warehouse as PW
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

torch.set_num_threads(2)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_npz(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert za.files == zb.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, equal_nan=True)


# ------------------------------------------------------------- generic_io

@pytest.mark.parametrize("fmt,end", [("f4", "l"), ("f4", "b"), ("f8", "l"), ("i2", "n")])
def test_raw_mat_files_are_byte_equal(tmp_path, rng, fmt, end):
    data = (rng.standard_normal((7, 3)) * 100).astype(np.float32)
    paths = {}
    for tag, mod in (("jax", JG), ("port", PG)):
        p = str(tmp_path / f"{tag}.bin")
        mod.write_raw_mat(data, p, fmt, end)
        mod.append_raw_mat(data[:2], p, fmt, end)
        paths[tag] = p
    assert _bytes(paths["jax"]) == _bytes(paths["port"])
    for col in (1, 3):
        np.testing.assert_array_equal(PG.read_raw_mat(paths["jax"], col, fmt, end),
                                      JG.read_raw_mat(paths["jax"], col, fmt, end))
    assert PG.raw_mat_num_elements(paths["jax"], fmt) == JG.raw_mat_num_elements(
        paths["jax"], fmt) == 27


@pytest.mark.parametrize("end", ["l", "b"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_htk_files_are_byte_equal(tmp_path, rng, ndim, end):
    data = rng.standard_normal((9, 4) if ndim == 2 else (9,)).astype(np.float32)
    pj, pp = str(tmp_path / "j.htk"), str(tmp_path / "p.htk")
    JG.write_htk(data, pj, 100000, 6, end)
    PG.write_htk(data, pp, 100000, 6, end)
    assert _bytes(pj) == _bytes(pp)
    assert PG.read_htk_header(pj, end) == JG.read_htk_header(pj, end)
    np.testing.assert_array_equal(PG.read_htk(pj, end), JG.read_htk(pj, end))
    assert PG.htk_num_frames(pj, end) == JG.htk_num_frames(pj, end) == 9


def _corpus(root, rng):
    """Three utterances: a waveform (reso 1), a 2-dim raw feature at 80
    ticks a frame, an HTK feature at 160, and a 1-frame utterance vector."""
    names = ["a", "b", "c"]
    for i, n in enumerate(names):
        frames = 12 + 5 * i
        save_wav(os.path.join(root, "wav", n + ".wav"),
                 (0.3 * rng.standard_normal(frames * 160)).astype(np.float32))
        os.makedirs(os.path.join(root, "f0"), exist_ok=True)
        PG.write_raw_mat(rng.standard_normal((frames * 2, 2)).astype(np.float32) + i,
                         os.path.join(root, "f0", n + ".f0"))
        os.makedirs(os.path.join(root, "mel"), exist_ok=True)
        PG.write_htk(rng.standard_normal((frames, 3)).astype(np.float32) * (i + 1),
                     os.path.join(root, "mel", n + ".htk"))
        os.makedirs(os.path.join(root, "utt"), exist_ok=True)
        PG.write_raw_mat(np.full((1, 2), i, np.float32), os.path.join(root, "utt", n + ".v"))
    return names


def _specs(mod, root):
    return ([mod.FeatureSpec(os.path.join(root, "wav"), ".wav", 1, 1),
             mod.FeatureSpec(os.path.join(root, "f0"), ".f0", 2, 80),
             mod.FeatureSpec(os.path.join(root, "utt"), ".v", 2, 160, normalize=False)],
            [mod.FeatureSpec(os.path.join(root, "mel"), ".htk", 3, 160)])


def _items_equal(pds, jds):
    assert len(pds) == len(jds)
    assert [s.to_str() for s in pds.seq_info] == [s.to_str() for s in jds.seq_info]
    for i in range(len(jds)):
        (px, py, pi), (jx, jy, ji) = pds[i], jds[i]
        assert pi.to_str() == ji.to_str()
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)


@pytest.mark.parametrize("truncate,min_len", [(None, None), (1000, None), (1000, 700)])
def test_generic_dataset_equals_the_jax_one(tmp_path, rng, truncate, min_len):
    root = str(tmp_path / "corpus")
    names = _corpus(root, rng)
    ds = {}
    for tag, mod in (("jax", JG), ("port", PG)):
        ins, outs = _specs(mod, root)
        ds[tag] = mod.GenericDataset("set", names, ins, outs, truncate_seq=truncate,
                                     min_seq_len=min_len, stats_dir=str(tmp_path / tag))
    _items_equal(ds["port"], ds["jax"])
    for k in ("in_mean", "in_std", "out_mean", "out_std"):
        np.testing.assert_array_equal(getattr(ds["port"], k), getattr(ds["jax"], k))
    _same_npz(str(tmp_path / "port" / "set_stats.npz"), str(tmp_path / "jax" / "set_stats.npz"))
    assert ds["port"].lengths() == ds["jax"].lengths()
    assert ds["port"].index_of("b") == ds["jax"].index_of("b")
    # each package reads the other's stats cache
    ins, outs = _specs(PG, root)
    again = PG.GenericDataset("set", names, ins, outs, truncate_seq=truncate,
                              min_seq_len=min_len, stats_dir=str(tmp_path / "jax"))
    _items_equal(again, ds["jax"])
    y = {tag: ds[tag][0][1] for tag in ds}
    for ext in (".htk", ".f0", ".wav"):
        outs = {}
        for tag in ("jax", "port"):
            spec = ds[tag].outputs[0]
            object.__setattr__(spec, "ext", ext)
            outs[tag] = ds[tag].put_item(y[tag], str(tmp_path / f"put_{tag}"), "x")
            object.__setattr__(spec, "ext", ".htk")
        assert os.path.basename(outs["port"]) == os.path.basename(outs["jax"])
        assert _bytes(outs["port"]) == _bytes(outs["jax"])


def test_concat_dataset_equals_the_jax_one(tmp_path, rng):
    roots = [str(tmp_path / "c1"), str(tmp_path / "c2")]
    names = [_corpus(r, rng) for r in roots]
    cat = {}
    for tag, mod in (("jax", JG), ("port", PG)):
        parts = []
        for r, n in zip(roots, names):
            ins, outs = _specs(mod, r)
            parts.append(mod.GenericDataset("s", n, ins, outs, truncate_seq=1200))
        cat[tag] = mod.ConcatDataset(parts)
    assert len(cat["port"]) == len(cat["jax"])
    assert cat["port"].lengths() == cat["jax"].lengths()
    assert cat["port"].seq_names() == cat["jax"].seq_names()
    for i in range(len(cat["jax"])):
        (px, py, pi), (jx, jy, ji) = cat["port"][i], cat["jax"][i]
        assert pi.to_str() == ji.to_str()
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)


@pytest.mark.parametrize("multiple", [1, 4, 16])
def test_collate_and_mask_equal_the_jax_ones(rng, multiple):
    items = [rng.standard_normal((n, 3)).astype(np.float32) for n in (5, 11, 2)]
    pb, pl = PG.collate_varlen(items, -1.0, multiple)
    jb, jl = JG.collate_varlen(items, -1.0, multiple)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pl, jl)
    assert pb.dtype == jb.dtype and pl.dtype == jl.dtype
    np.testing.assert_array_equal(PG.length_mask(pl, pb.shape[1]),
                                  JG.length_mask(jl, jb.shape[1]))
    assert PG.pad_to_bucket(11, multiple) == JG.pad_to_bucket(11, multiple)
    info = PG.SeqInfo(40, "utt_x", 2, 80, 7)
    assert info.to_str() == JG.SeqInfo(40, "utt_x", 2, 80, 7).to_str()
    assert PG.SeqInfo.from_str(info.to_str()) == info


# ------------------------------------------------------------------ stats

@pytest.mark.parametrize("track_cov", [False, True])
def test_online_stats_equal_the_jax_ones(rng, track_cov):
    p, j = PST.OnlineStats(4, track_cov), JST.OnlineStats(4, track_cov)
    for n in (1, 7, 0, 30, 3):
        batch = rng.standard_normal((n, 4)) * 3 + 1
        p.update(batch)
        j.update(batch)
    assert p.count == j.count
    for k in ("mean", "var", "std", "cov"):
        if getattr(j, k) is not None:
            _close(getattr(p, k), getattr(j, k))
    back = PST.OnlineStats.from_state_dict(j.state_dict())
    _close(back.var, j.var)


def test_significance_tests_and_rank_norm_equal_the_jax_ones(rng):
    a, b = rng.standard_normal(40), rng.standard_normal(40) + 0.3
    _close(PST.paired_t_pvalue(a, b), JST.paired_t_pvalue(a, b))
    pv = list(rng.uniform(0, 0.1, size=9))
    assert PST.bonferroni(pv, 0.05) == JST.bonferroni(pv, 0.05)
    assert PST.holm(pv, 0.05) == JST.holm(pv, 0.05)
    scores = list(rng.integers(1, 6, size=30))
    _close(PST.rank_norm(scores, [1, 5]), JST.rank_norm(scores, [1, 5]))
    with pytest.raises(ValueError):
        PST.rank_norm([0, 3], [1, 5])


# -------------------------------------------------------------- filelists

def test_filelists_equal_the_jax_ones(tmp_path):
    root = tmp_path / "d"
    for rel in ("a.wav", "b.flac", ".hidden.wav", "sub/c.wav", "sub/.x/d.wav", "e.wav"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text("x")
    for kw in ({}, {"ext": ".wav"}, {"recursive": True}, {"ext": ".wav", "recursive": True}):
        assert PF.listdir_stems(str(root), **kw) == JF.listdir_stems(str(root), **kw)
    a, b = ["x", "y", "z", "y"], ["y", "w"]
    assert PF.common_members(a, b) == JF.common_members(a, b)
    assert PF.members_not_in(a, b) == JF.members_not_in(a, b)
    assert PF.is_permutation(a, a[::-1]) and not PF.is_permutation(a, b)
    assert PF.is_subset(a, ["x"]) == JF.is_subset(a, ["x"])
    lst = str(tmp_path / "l.txt")
    PF.write_lines([1, "two", 3.5], lst)
    assert PF.read_lines(lst) == JF.read_lines(lst) == ["1", "two", "3.5"]
    assert PF.resolve_path("d", "n", "wav") == JF.resolve_path("d", "n", "wav")
    assert PF.resolve_path("d", "n", ".wav") == JF.resolve_path("d", "n", ".wav")


@pytest.mark.parametrize("block", [1, 3, 4])
def test_block_shuffles_equal_the_jax_ones(block):
    items = list(range(14))
    for fn in ("shuffle_within_blocks", "shuffle_blocks"):
        got = getattr(PF, fn)(items, block, np.random.default_rng(5))
        want = getattr(JF, fn)(items, block, np.random.default_rng(5))
        assert got == want, fn


def test_random_name_map_equals_the_jax_one(tmp_path):
    pool = [f"name{i}" for i in range(5)]
    p, j = PF.RandomNameMap(pool), JF.RandomNameMap(pool)
    for f in ("u1", "u2", "u1", "u3"):
        assert p.alias_for(f) == j.alias_for(f)
    assert p.items() == j.items() and p.num_unused == j.num_unused
    assert p.filename_for(p.alias_for("u2")) == "u2"
    p.save_unused(str(tmp_path / "p.txt"))
    j.save_unused(str(tmp_path / "j.txt"))
    assert _bytes(str(tmp_path / "p.txt")) == _bytes(str(tmp_path / "j.txt"))
    with pytest.raises(KeyError):
        p.filename_for("nope")


# ------------------------------------------------------------------- text

TEXTS = [
    "hello we are {AY2_AY2_ _AY2_AY2} the same 123",
    "Hello, World!  multiple   spaces",
    "{AH0_B_AH1_V}",
    "edge {K_AE1_T} middle {D_AO1_G} end",
    "punct: a-b c'd (e) f?",
    "42",
    "",
    "unknown chars é ü 7x",
]


def test_symbol_table_is_the_jax_one():
    assert PT.SYMBOLS == JT.SYMBOLS
    assert PT.symbol_count() == JT.symbol_count() and PT.eos_index() == JT.eos_index()


@pytest.mark.parametrize("text", TEXTS)
def test_text_codes_equal_the_jax_ones(text):
    got, want = PT.text_to_codes(text), JT.text_to_codes(text)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert PT.codes_to_text(got) == JT.codes_to_text(want)
    assert PT.parse_curly_bracket(text) == JT.parse_curly_bracket(text)
    assert PT.normalize_text(text) == JT.normalize_text(text)


def test_g2p_and_text_files_equal_the_jax_ones(tmp_path):
    def g2p(text):
        return [" ", "HH", "AH0", " ", "L", "OW1", " ", ",", " ", "W", "ER1", "L", "D"]

    np.testing.assert_array_equal(PT.g2p_to_codes("hello, world", g2p),
                                  JT.g2p_to_codes("hello, world", g2p))
    assert PT.clean_g2p_symbols(g2p("")) == JT.clean_g2p_symbols(g2p(""))
    with pytest.raises(ValueError):
        PT.g2p_to_codes("a {AH}", g2p)
    path = tmp_path / "t.txt"
    path.write_text("first line 12\r\nsecond {K_AE1_T}\n")
    np.testing.assert_array_equal(PT.load_text_file(str(path)), JT.load_text_file(str(path)))
    plain = tmp_path / "plain.txt"
    plain.write_text("hello, world\n")
    np.testing.assert_array_equal(PT.load_text_file(str(plain), g2p=g2p),
                                  JT.load_text_file(str(plain), g2p=g2p))


# -------------------------------------------------------------- warehouse

def test_warehouse_views_equal_the_jax_ones(tmp_path):
    path = tmp_path / "res.txt"
    rows = [f"sys{s} A{a:02d} {m} {0.1 * (s + 1) * (a + 1) + (m == 'eer'):.4f}"
            for s in range(3) for a in range(4) for m in ("eer", "tdcf") if (s, a) != (2, 3)]
    path.write_text("\n".join(rows) + "\n\n")
    value = lambda ln: float(ln.split()[3])  # noqa: E731
    tags = [lambda ln: ln.split()[0], lambda ln: ln.split()[1], lambda ln: ln.split()[2]]
    p = PW.DataWarehouse(str(path), [value], [tags])
    j = JW.DataWarehouse(str(path), [value], [tags])
    assert p.entries == j.entries
    assert [p.tags(i) for i in range(4)] == [j.tags(i) for i in range(4)]
    assert p.view([0, 2], ["sys1", "eer"]) == j.view([0, 2], ["sys1", "eer"])
    tv = [j.tags(0), j.tags(1)]
    assert p.cross_view([0, 1], tv) == j.cross_view([0, 1], tv)
    _close(p.cross_view([0, 1], tv, to_numpy=True), j.cross_view([0, 1], tv, to_numpy=True))
    _close(p.cross_view([0, 1], tv, to_numpy=True, statistics=np.mean),
           j.cross_view([0, 1], tv, to_numpy=True, statistics=np.mean))
    with pytest.raises(ValueError):
        p.view([0, 1], ["sys1"])


# ------------------------------------------------------------- schedulers

@pytest.mark.parametrize("epoch", [0, 1, 7, 29, 30, 31, 95])
def test_schedules_equal_the_jax_ones(epoch):
    _close(PS.step_lr(epoch, 0.1), JS.step_lr(epoch, 0.1))
    _close(PS.exponential_lr(epoch, 0.1, 0.95), JS.exponential_lr(epoch, 0.1, 0.95))
    for t_mult in (1, 2):
        _close(PS.cosine_warm_restarts(epoch + 0.5, 0.1, 10, t_mult, 1e-4),
               JS.cosine_warm_restarts(epoch + 0.5, 0.1, 10, t_mult, 1e-4))
    assert set(PS.SCHEDULES) == set(JS.SCHEDULES)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_equals_the_jax_one(mode):
    p = PS.ReduceLROnPlateau(1e-3, mode, factor=0.5, patience=2, min_lr=1e-5)
    j = JS.ReduceLROnPlateau(1e-3, mode, factor=0.5, patience=2, min_lr=1e-5)
    for metric in (1.0, 0.9, 0.95, 0.95, 0.95, 0.7, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8):
        assert p.step(metric) == j.step(metric)
        assert p.state_dict() == j.state_dict()
    p.load_state_dict(j.state_dict())


# ---------------------------------------------------------------- monitor

def test_monitor_state_round_trips_through_the_port_checkpoint(tmp_path, rng):
    p, j = PM.Monitor(3, 4), JM.Monitor(3, 4)
    for epoch in range(2):
        for step in range(4 - epoch):
            losses = {"loss": float(rng.uniform()), "ce": float(rng.uniform())}
            for mon in (p, j):
                mon.log_step(epoch, step, losses)
        assert p.end_epoch(epoch) == j.end_epoch(epoch)
        assert p.epoch_mean(epoch) == j.epoch_mean(epoch)
        assert p.summary(epoch) == j.summary(epoch)
    state = p.state_dict()
    path = str(tmp_path / "monitor.ckpt")
    pckpt.save(path, {k: v for k, v in state.items() if k != "meta"}, extra=state["meta"])
    tree, meta = pckpt.load(path)
    back = PM.Monitor.from_state_dict({**tree, "meta": meta})
    jtree, jmeta = jckpt.load(path)  # the JAX checkpointer reads the same file
    jback = JM.Monitor.from_state_dict({**jtree, "meta": jmeta})
    for mon in (back, jback):
        assert mon.best_epoch == j.best_epoch and mon.best_value == j.best_value
        np.testing.assert_array_equal(mon.seen_steps, j.seen_steps)
        for k in j.loss_mats:
            np.testing.assert_array_equal(mon.loss_mats[k], j.loss_mats[k])
        assert mon.epoch_mean(1)["loss"] == j.epoch_mean(1)["loss"]


# ------------------------------------------------------------------- logs

def test_metrics_jsonl_of_the_port_engine_reads_as_the_jax_ones(tmp_path):
    from scl_deepfake_audio_detection_torch.train.engine import Engine
    from scl_deepfake_audio_detection_torch.utils.config import TrainConfig

    rng = np.random.default_rng(3)
    batch = {"wav": (0.2 * rng.standard_normal((1, 4, 4000))).astype(np.float32),
             "labels": np.array([[1, 1, 0, 0]], np.float32)}
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu")
    Engine(model, TrainConfig(num_epochs=2, early_metric="eer")).fit(
        lambda: [batch], lambda: [batch], save_dir=str(tmp_path))
    path = str(tmp_path / "metrics.jsonl")
    got, want = PL.read_metrics_jsonl(path), JL.read_metrics_jsonl(path)
    assert list(got) == list(want) and "train_loss" in got and "val_eer" in got
    for k in want:
        _close(got[k], want[k])


def test_reference_log_parsers_equal_the_jax_ones(tmp_path):
    err = tmp_path / "log_err"
    lines = ["starting up"]
    for ep in range(2):
        lines += [f"{i},utt{i},0,9216,0, {i + 1}/3, Time: 0.{i + 1}s, Loss: {ep + i}.5, "
                  f"Loss: 1.{i}" for i in range(3)]
        lines += [f"{i},dev{i},0,9216,0, {i + 1}/2, Time: 0.3s, Loss: {ep}.25"
                  for i in range(2)]
    err.write_text("\n".join(lines) + "\n")
    for fn, kw in (("read_log_err", {}), ("read_log_err_epochs", {}),
                   ("read_log_err_epochs", {"merge_epoch": True})):
        got, want = getattr(PL, fn)(str(err), **kw), getattr(JL, fn)(str(err), **kw)
        for g, w in zip(got, want):
            _close(g, w)
    train = tmp_path / "log_train"
    train.write_text("Epoch | Duration | Train | Val | Best\n----- | --- | --- | --- | --\n"
                     "1 | 120.5 | 2.0/0.5 | 2.2/0.6 | yes\n2 | 118.0 | 1.5 0.1/0.4/0.3 | "
                     "1.9/0.5 | no\nfooter | x | y | z | w\n")
    for g, w in zip(PL.read_log_train(str(train)), JL.read_log_train(str(train))):
        _close(g, w)


# ------------------------------------------------------------------ probe

def test_probe_dump_and_quick_write_equal_the_jax_ones(tmp_path, rng):
    """A probe of tensors dumps what the JAX probe dumps of the same arrays."""
    feats = rng.standard_normal((2, 5, 3)).astype(np.float32)
    probes = {"port": PP.DataProbe(), "jax": JP.DataProbe()}
    for tag, pr in probes.items():
        wrap = torch.from_numpy if tag == "port" else np.asarray
        pr.add(wrap(feats), name="layer")
        pr.add(wrap(feats[:, :2].copy()), name="layer")
        pr.add(np.float64(2.5))
    assert probes["port"].names() == probes["jax"].names()
    np.testing.assert_array_equal(probes["port"].get("layer"), probes["jax"].get("layer"))
    paths = {tag: pr.dump(str(tmp_path / tag / "run")) for tag, pr in probes.items()}
    _same_npz(paths["port"], paths["jax"])
    with np.load(paths["port"]) as zp:
        assert zp.files == ["layer", "layer#1", "probe2"]
    qp = PP.quick_write(torch.from_numpy(feats), str(tmp_path / "q" / "p.bin"))
    qj = JP.quick_write(feats, str(tmp_path / "q" / "j.bin"))
    assert _bytes(qp) == _bytes(qj)
    np.testing.assert_array_equal(PG.read_raw_mat(qp, 3), feats.reshape(-1, 3))
    x = torch.tensor([1.0, 2.0], dtype=torch.bfloat16, requires_grad=True)
    assert PP.to_host(x).dtype == np.float32
    assert PP.to_host(3).shape == () and PP.to_host([1, 2]).tolist() == [1, 2]


def test_param_moments_are_keyed_as_the_jax_ones():
    import jax

    jm = JLinearNLL(ssl=JX.XLSRConfig.tiny(), emb_dim=16)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    model = LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu")
    load_jax_params(model, tree)
    got, want = PP.param_moments(model), JP.param_moments(tree)
    assert list(got) == list(want)
    assert got == want
    assert PP.param_moments(tree) == want
