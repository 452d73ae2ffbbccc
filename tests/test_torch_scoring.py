"""The port's scoring host code against the JAX package, on the CPU.

``train/scoring`` (the resume parser, bucketed batches, long-audio crops and
every score-file writer), ``data/sampler``, ``data/generic_io.pad_to_bucket``
and ``EvalDataset.get_raw`` of ``scl_deepfake_audio_detection_torch`` are
held to their JAX twins given the same numpy ``score_fn``: batches equal
array for array, files equal byte for byte.  The port's writers also take a
``score_fn`` that returns a torch tensor, as ``score_step`` does on the
card, and must write the same bytes.
"""

import os

import numpy as np
import pytest
import torch

from scl_deepfake_audio_detection_tpu.data import generic_io as JG
from scl_deepfake_audio_detection_tpu.data import sampler as JS
from scl_deepfake_audio_detection_tpu.data.datasets import EvalDataset as JEvalDataset
from scl_deepfake_audio_detection_tpu.train import scoring as J
from scl_deepfake_audio_detection_torch.data import generic_io as PG
from scl_deepfake_audio_detection_torch.data import sampler as PS
from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
from scl_deepfake_audio_detection_torch.train import scoring as P


def score_np(wav):
    """A deterministic stand-in for the model: [B, T] -> log-probs [B, 2]
    from each row's mean and spread, float32."""
    wav = np.asarray(wav, np.float32)
    z = np.stack([wav.mean(-1) * 40.0, wav.std(-1) * 3.0 - 0.3], -1).astype(np.float32)
    return (z - np.logaddexp(z[:, :1], z[:, 1:])).astype(np.float32)


def score_torch(wav):
    return torch.from_numpy(score_np(wav))


def emb_np(wav):
    wav = np.asarray(wav, np.float32)
    emb = np.stack([wav[:, i::8].mean(-1) for i in range(8)], -1).astype(np.float32)
    return score_np(wav), emb


def emb_torch(wav):
    lp, emb = emb_np(wav)
    return torch.from_numpy(lp), torch.from_numpy(emb)


def _wavs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.normal(size=n) + 0.01 * i).astype(np.float32)
            for i, n in enumerate(lengths)]


def _batches(n=7, batch=3, t=500, seed=1):
    """Fixed-shape batches as EvalLoader gives them: the last one padded
    with zero rows beyond its utts."""
    wavs = _wavs([t] * n, seed)
    for i in range(0, n, batch):
        rows = wavs[i : i + batch]
        utts = [f"dir/u{j}.flac" for j in range(i, i + len(rows))]
        rows = rows + [np.zeros(t, np.float32)] * (batch - len(rows))
        yield np.stack(rows), utts


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


# ------------------------------------------------------------ read_valid_rows


@pytest.mark.parametrize("text,n_tokens", [
    ("a.flac -1.5 -0.25\nb.flac -1.0 -0.5\nc.flac -0.7 -0.", 3),  # torn last line
    ("a.flac -1.5 -0.25\na.flac -9 -9\nb.flac 1 2\n", 3),  # repeated utt
    ("a.flac -1.5 nan\nb.flac x 1\nc.flac 1\nd.flac 1 2 3\ne.flac 0.5 1\n", 3),
    ("a.flac 0.25\nb.flac 1 0\nc.flac inf\n", 2),
    ("", 3),
])
def test_read_valid_rows_matches_jax(tmp_path, text, n_tokens):
    path = tmp_path / "scores.txt"
    path.write_text(text)
    assert P.read_valid_rows(str(path), n_tokens) == J.read_valid_rows(str(path), n_tokens)


def test_read_valid_rows_of_a_missing_file_is_empty_like_jax(tmp_path):
    path = str(tmp_path / "none.txt")
    assert P.read_valid_rows(path) == J.read_valid_rows(path) == ([], set())


# ------------------------------------------------------------------ samplers


@pytest.mark.parametrize("length,multiple", [(0, 16000), (1, 16000), (16000, 16000),
                                             (16001, 16000), (99, 7)])
def test_pad_to_bucket_matches_jax(length, multiple):
    assert PG.pad_to_bucket(length, multiple) == JG.pad_to_bucket(length, multiple)


@pytest.mark.parametrize("block_size", [1, 3, 4])
def test_block_shuffle_by_length_matches_jax(block_size):
    lengths = np.random.default_rng(2).integers(100, 900, 17)
    got = PS.block_shuffle_by_length(lengths, block_size, np.random.default_rng(5))
    assert got == JS.block_shuffle_by_length(lengths, block_size, np.random.default_rng(5))
    assert sorted(got) == list(range(17))


@pytest.mark.parametrize("boundaries", [None, [300, 600, 900], [200, 500]])
def test_length_buckets_match_jax(boundaries):
    lengths = list(np.random.default_rng(3).integers(100, 1000, 23))
    got = list(PS.length_buckets(lengths, 4, boundaries))
    assert got == list(JS.length_buckets(lengths, 4, boundaries))


# ---------------------------------------------------------- bucketed batches


@pytest.mark.parametrize("bucket_multiple,max_len,padding_type", [
    (16000, None, "repeat"), (16000, 40000, "repeat"), (0, None, "zero"),
    (0, 30000, "repeat"), (7000, None, "zero")])
def test_bucketed_batches_match_jax(bucket_multiple, max_len, padding_type):
    lengths = [40000, 9000, 52000, 16000, 75000, 31000, 112000, 23000, 64000, 47000]
    wavs, utts = _wavs(lengths), [f"u{i}.wav" for i in range(len(lengths))]
    kw = dict(bucket_multiple=bucket_multiple, padding_type=padding_type, max_len=max_len)
    got = list(P.bucketed_batches(wavs, utts, 4, **kw))
    want = list(J.bucketed_batches(wavs, utts, 4, **kw))
    assert len(got) == len(want) == 3
    for (gw, gu), (ww, wu) in zip(got, want):
        assert gu == wu and gw.dtype == ww.dtype and gw.shape == ww.shape
        np.testing.assert_array_equal(gw, ww)


def test_bucketed_batches_reject_mismatched_lists_like_jax():
    for mod in (J, P):
        with pytest.raises(ValueError, match="mismatch"):
            list(mod.bucketed_batches(_wavs([10, 20]), ["a"], 2))


# --------------------------------------------------------------- long audio


@pytest.mark.parametrize("n,hop,batch", [(30000, None, 8), (64600, None, 8),
                                         (150000, None, 2), (260000, None, 8),
                                         (100001, 20000, 3)])
@pytest.mark.parametrize("score_fn", [score_np, score_torch])
def test_score_long_audio_matches_jax(n, hop, batch, score_fn):
    (wav,) = _wavs([n], seed=n)
    got = P.score_long_audio(wav, score_fn, hop=hop, batch=batch)
    want = J.score_long_audio(wav, score_np, hop=hop, batch=batch)
    assert got.dtype == want.dtype and got.shape == want.shape == (2,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,starts", [(30000, [0]), (64600, [0]),
                                      (150000, [0, 32300, 64600, 85400])])
def test_long_audio_starts(n, starts):
    assert P.long_audio_starts(n) == starts


# ------------------------------------------------------------------- writers


@pytest.mark.parametrize("writer", ["produce_evaluation_file", "produce_prediction_file"])
@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("score_fn", [score_np, score_torch])
def test_score_writers_write_the_jax_bytes(tmp_path, writer, append, score_fn):
    outs = {}
    for name, mod, fn in (("jax", J, score_np), ("port", P, score_fn)):
        out = tmp_path / name / "scores.txt"
        if append:
            out.parent.mkdir()
            out.write_text("kept.flac -1.0 -0.5\n")
        seen = []
        getattr(mod, writer)(_batches(), fn, str(out), progress=seen.append, append=append)
        outs[name] = (_read(out, "rb"), seen)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == [3, 6, 7]


class _RawDataset:
    def __init__(self, lengths):
        self.wavs = _wavs(lengths, seed=4)

    def __len__(self):
        return len(self.wavs)

    def get_raw(self, idx):
        return self.wavs[idx], f"clip{idx}.wav"


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("score_fn", [score_np, score_torch])
def test_long_audio_writer_writes_the_jax_bytes(tmp_path, append, score_fn):
    ds = _RawDataset([9000, 64600, 150000, 70000, 200001])
    outs = {}
    for name, mod, fn in (("jax", J, score_np), ("port", P, score_fn)):
        out = tmp_path / name / "long.txt"
        if append:
            out.parent.mkdir()
            out.write_text("kept.wav -1.0 -0.5\n")
        seen = []
        mod.produce_long_audio_evaluation_file(ds, fn, str(out), batch=3,
                                               progress=seen.append, append=append)
        outs[name] = (_read(out, "rb"), seen)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("emb_fn", [emb_np, emb_torch])
def test_emb_writer_writes_the_jax_files(tmp_path, emb_fn):
    J.produce_emb_file(_batches(), emb_np, str(tmp_path / "jax"))
    seen = []
    P.produce_emb_file(_batches(), emb_fn, str(tmp_path / "port"), progress=seen.append)
    assert seen == [3, 6, 7]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 8
    for name in names:
        got, want = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".npy"):
            g, w = np.load(got), np.load(want)
            assert g.dtype == w.dtype and g.shape == w.shape == (8,)
            np.testing.assert_array_equal(g, w)
        else:
            assert _read(got, "rb") == _read(want, "rb")


# -------------------------------------------------------------- EvalDataset


@pytest.mark.parametrize("subdir", [True, False])
def test_eval_dataset_get_raw_matches_jax(tmp_path, subdir):
    from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav

    lengths = [3000, 64600, 90001]
    base = tmp_path / "eval" if subdir else tmp_path
    utts = [f"r{i}.wav" for i in range(len(lengths))]
    for u, w in zip(utts, _wavs(lengths, seed=6)):
        save_wav(str(base / u), w)
    got = EvalDataset(utts, str(tmp_path), use_eval_subdir=subdir)
    want = JEvalDataset(utts, str(tmp_path), use_eval_subdir=subdir)
    for i, n in enumerate(lengths):
        (gw, gu), (ww, wu) = got.get_raw(i), want.get_raw(i)
        assert gu == wu == utts[i] and gw.shape == ww.shape == (n,)
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(got.get(i)[0], want.get(i)[0])
