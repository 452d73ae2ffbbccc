"""The port's score-analysis modules against their JAX twins, on the CPU.

``train/metrics``, ``data/protocols``, ``train/calibration`` and
``train/analysis`` of ``scl_deepfake_audio_detection_torch`` are copies of
the JAX package's numpy code, so each function is held to its twin on the
same seeded scores, ASV scores and written protocols (ASVspoof five-column
and subset formats) to equality (``rtol=0, atol=1e-12``), and every report
string and written file to an equal string.  The logistic fits use fixed
seeds only.
"""

import dataclasses
import os

import numpy as np
import pytest

from scl_deepfake_audio_detection_tpu.data import protocols as JP
from scl_deepfake_audio_detection_tpu.train import analysis as JAn
from scl_deepfake_audio_detection_tpu.train import calibration as JC
from scl_deepfake_audio_detection_tpu.train import metrics as JM
from scl_deepfake_audio_detection_torch.data import protocols as PP
from scl_deepfake_audio_detection_torch.train import analysis as PAn
from scl_deepfake_audio_detection_torch.train import calibration as PC
from scl_deepfake_audio_detection_torch.train import metrics as PM

ATTACKS = ("A07", "A08", "A09")


def _same(got, want):
    """Equal structure; numbers to 1e-12, everything else exactly."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (np.ndarray, float, np.floating)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert np.shape(got) == np.shape(want)
    else:
        assert got == want


def _scores(seed, n_tar=60, n_non=90, shift=1.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(shift, 1.0, n_tar), rng.normal(0.0, 1.2, n_non))


def _asv(seed, spoof=True):
    rng = np.random.default_rng(seed)
    return (rng.normal(3.0, 1.0, 80), rng.normal(-2.0, 1.0, 120),
            rng.normal(1.0, 1.5, 50 if spoof else 0))


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["det_curve", "compute_eer"])
def test_eer_and_det_curve_match_jax(name, seed):
    tar, non = _scores(seed)
    tar = np.round(tar, 1)  # ties
    _same(getattr(PM, name)(tar, non), getattr(JM, name)(tar, non))


@pytest.mark.parametrize("threshold", [-0.5, 0.0, 0.7])
def test_confusion_counts_match_jax(threshold):
    tar, non = _scores(3)
    got = PM.confusion_counts(tar, non, threshold)
    assert got == JM.confusion_counts(tar, non, threshold)
    assert all(type(x) is int for x in got)


def test_accuracy_from_log_probs_matches_jax():
    rng = np.random.default_rng(4)
    lp = rng.normal(size=(50, 2))
    labels = rng.integers(0, 2, 50)
    assert PM.accuracy_from_log_probs(lp, labels) == JM.accuracy_from_log_probs(lp, labels)


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_asv_error_rates_match_jax(threshold):
    args = _asv(5)
    _same(PM.asv_error_rates(*args, threshold), JM.asv_error_rates(*args, threshold))


def test_asv_error_rates_without_spoof_trials_raise_like_jax():
    args = _asv(5, spoof=False)
    with pytest.raises(ValueError, match="spoof-trial ASV scores"):
        JM.asv_error_rates(*args)
    with pytest.raises(ValueError, match="spoof-trial ASV scores"):
        PM.asv_error_rates(*args)


@pytest.mark.parametrize("version,costs", [("legacy", None), ("revised", None),
                                           ("legacy", {"Cfa_cm": 5.0}),
                                           ("revised", {"Pspoof": 0.1})])
def test_tdcf_curve_and_min_tdcf_match_jax(version, costs):
    bona, spoof = _scores(6)
    pfa, pmiss, _, pfa_spoof = JM.asv_error_rates(*_asv(7))
    _same(PM.tdcf_curve(bona, spoof, pfa, pmiss, pfa_spoof, version, costs),
          JM.tdcf_curve(bona, spoof, pfa, pmiss, pfa_spoof, version, costs))
    for thr in (None, 0.3):
        _same(PM.min_tdcf(bona, spoof, *_asv(7), version, costs, thr),
              JM.min_tdcf(bona, spoof, *_asv(7), version, costs, thr))


@pytest.mark.parametrize("args,match", [
    (("nope",), "unknown t-DCF version"),
    (("legacy", None, 0.9, 0.99), "non-positive t-DCF cost"),
])
def test_tdcf_errors_match_jax(args, match):
    bona, spoof = _scores(8)
    version = args[0]
    pfa, pmiss = (args[2], args[3]) if len(args) > 2 else (0.01, 0.02)
    for mod in (JM, PM):
        with pytest.raises(ValueError, match=match):
            mod.tdcf_curve(bona, spoof, pfa, pmiss, 0.5, version)


@pytest.mark.parametrize("n_boot,alpha,seed", [(50, 0.05, 0), (80, 0.1, 3)])
def test_eer_bootstrap_ci_matches_jax(n_boot, alpha, seed):
    tar, non = _scores(9, 30, 40)
    _same(PM.eer_bootstrap_ci(tar, non, n_boot, alpha, seed),
          JM.eer_bootstrap_ci(tar, non, n_boot, alpha, seed))


@pytest.mark.parametrize("n_boot,seed", [(50, 0), (60, 11)])
def test_eer_diff_bootstrap_matches_jax(n_boot, seed):
    ta, na = _scores(10, 30, 40)
    tb, nb = ta + np.random.default_rng(1).normal(0, 0.5, 30), na - 0.2
    _same(PM.eer_diff_bootstrap(ta, na, tb, nb, n_boot, seed=seed),
          JM.eer_diff_bootstrap(ta, na, tb, nb, n_boot, seed=seed))


@pytest.mark.parametrize("call,match", [
    (lambda m, t, n: m.eer_diff_bootstrap(t, n, t[:-1], n), "trial-aligned"),
    (lambda m, t, n: m.eer_diff_bootstrap(t, n, t, n, n_boot=1), "n_boot"),
    (lambda m, t, n: m.eer_bootstrap_ci(t, n, n_boot=1), "n_boot"),
    (lambda m, t, n: m.det_curve(t, n[:0]), "non-empty"),
])
def test_metric_argument_errors_match_jax(call, match):
    tar, non = _scores(12, 10, 10)
    for mod in (JM, PM):
        with pytest.raises(ValueError, match=match):
            call(mod, tar, non)


# ---------------------------------------------------------------- protocols


def _write_protocols(root, n=24, seed=13):
    """The same trials as an ASVspoof five-column protocol and as a subset
    protocol, with one unlabelled line each; -> (asvspoof path, subset
    path, utts)."""
    rng = np.random.default_rng(seed)
    utts = [f"LA_E_{i:05d}" for i in range(n)]
    labels = ["bonafide" if i % 3 == 0 else "spoof" for i in range(n)]
    attacks = ["-" if lab == "bonafide" else ATTACKS[rng.integers(0, 3)]
               for lab in labels]
    asv = root / "asvspoof.txt"
    asv.write_text("".join(f"LA_{i % 5:04d} {u} - {a} {lab}\n"
                           for i, (u, a, lab) in enumerate(zip(utts, attacks, labels)))
                   + "LA_0009 LA_E_99999 - A07 unknown\n")
    sub = root / "subset.txt"
    sub.write_text("".join(f"wav/{u}.flac {'dev' if i % 2 else 'eval'} {lab}\n"
                           for i, (u, lab) in enumerate(zip(utts, labels)))
                   + "wav/LA_E_99999.flac eval bona-fide\n\n")
    return str(asv), str(sub), utts


@pytest.mark.parametrize("fmt", ["asvspoof", "subset"])
def test_protocol_parsers_match_jax(tmp_path, fmt):
    asv, sub, _ = _write_protocols(tmp_path)
    path = asv if fmt == "asvspoof" else sub
    assert PP.sniff_protocol(path) == JP.sniff_protocol(path) == fmt
    got, want = PP.parse_protocol(path), JP.parse_protocol(path)
    assert [dataclasses.astuple(t) for t in got] == [dataclasses.astuple(t) for t in want]
    parse = {"asvspoof": "parse_asvspoof_protocol", "subset": "parse_subset_protocol"}[fmt]
    assert getattr(PP, parse)(path) == got
    for strip in (False, True):
        assert PP.label_map(got, strip_ext=strip) == JP.label_map(want, strip_ext=strip)


@pytest.mark.parametrize("parse,line", [("parse_asvspoof_protocol", "a b c d\n"),
                                        ("parse_subset_protocol", "a b\n")])
def test_protocol_parsers_reject_short_lines_like_jax(tmp_path, parse, line):
    path = tmp_path / "bad.txt"
    path.write_text(line)
    for mod in (JP, PP):
        with pytest.raises(ValueError, match="bad"):
            getattr(mod, parse)(str(path))


# -------------------------------------------------------------- calibration


@pytest.mark.parametrize("seed", [21, 22])
def test_logistic_calibration_matches_jax(seed):
    tar, non = _scores(seed)
    _same(PC.logistic_calibration(tar, non), JC.logistic_calibration(tar, non))
    a, b = JC.logistic_calibration(tar, non)
    _same(PC.apply_calibration(tar, a, b), JC.apply_calibration(tar, a, b))


@pytest.mark.parametrize("seed,k", [(31, 2), (32, 3)])
def test_logistic_fusion_matches_jax(seed, k):
    rng = np.random.default_rng(seed)
    tar = rng.normal(1.0, 1.0, (40, k)) * rng.uniform(0.5, 2.0, k)
    non = rng.normal(-0.5, 1.0, (55, k))
    w, b = JC.logistic_fusion(tar, non)
    _same(PC.logistic_fusion(tar, non), (w, b))
    _same(PC.fuse_scores(tar, w, b), JC.fuse_scores(tar, w, b))


def test_logistic_fits_reject_bad_input_like_jax():
    for mod in (JC, PC):
        with pytest.raises(ValueError, match="non-empty"):
            mod.logistic_calibration(np.ones(3), np.ones(0))
        with pytest.raises(ValueError, match="matching K"):
            mod.logistic_fusion(np.ones((3, 2)), np.ones((3, 3)))


@pytest.mark.parametrize("seed", [41, 42])
def test_cllr_and_min_cllr_match_jax(seed):
    tar, non = _scores(seed)
    tar[:3] = np.round(tar[:3])  # ties
    _same(PC.cllr(tar, non), JC.cllr(tar, non))
    _same(PC.min_cllr(tar, non), JC.min_cllr(tar, non))


@pytest.mark.parametrize("weighted", [False, True])
def test_pav_matches_jax(weighted):
    rng = np.random.default_rng(43)
    y = rng.normal(size=40).cumsum() * rng.choice([-1, 1], 40)
    w = rng.uniform(0.1, 2.0, 40) if weighted else None
    _same(PC.pav(y, w), JC.pav(y, w))


@pytest.mark.parametrize("p_target,c_miss,c_fa", [(0.05, 1.0, 1.0), (0.5, 1.0, 10.0)])
def test_act_dcf_matches_jax(p_target, c_miss, c_fa):
    tar, non = _scores(44)
    _same(PC.act_dcf(tar, non, p_target, c_miss, c_fa),
          JC.act_dcf(tar, non, p_target, c_miss, c_fa))


# ------------------------------------------------------------------ analysis


def _write_scores(path, utts, seed, fmt="eval", shift=1.0, labels=None):
    """A score file over ``utts`` (eval format ``utt cm0 cm1`` or pred
    format ``utt score pred``); bonafide rows (``labels``) score higher."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i, u in enumerate(utts):
            s = rng.normal() + (shift if labels and labels[i] else 0.0)
            if fmt == "eval":
                f.write(f"{u}.flac {-abs(s) - 0.1} {s}\n")
            else:
                f.write(f"{u}.flac {s} {int(s > 0)}\n")
        f.write("short line\n")
    return str(path)


def _analysis_files(root):
    asv_proto, sub_proto, utts = _write_protocols(root)
    labels = [i % 3 == 0 for i in range(len(utts))]
    a = _write_scores(root / "a.txt", utts, 51, labels=labels)
    b = _write_scores(root / "b.txt", utts[:-2], 52, shift=0.6, labels=labels)
    p = _write_scores(root / "p.txt", utts, 53, fmt="pred", labels=labels)
    rng = np.random.default_rng(54)
    asv = root / "asv.txt"
    asv.write_text("".join(f"LA_0001 {k} {rng.normal(m, 1.0)}\n" for k, m, n in
                           (("target", 3, 30), ("nontarget", -2, 40), ("spoof", 1, 20))
                           for _ in range(n)) + "LA_0001 target notafloat\nbad\n")
    return dict(asv_proto=asv_proto, sub_proto=sub_proto, a=a, b=b, p=p, asv=str(asv))


@pytest.mark.parametrize("key,fmt", [("a", "auto"), ("a", "eval"), ("p", "auto"),
                                     ("p", "pred"), ("a", "pred")])
def test_load_scores_matches_jax(tmp_path, key, fmt):
    f = _analysis_files(tmp_path)
    assert PAn.load_scores(f[key], fmt) == JAn.load_scores(f[key], fmt)


@pytest.mark.parametrize("proto,subset,per_attack,boot", [
    ("asv_proto", None, True, 0), ("asv_proto", None, False, 40),
    ("sub_proto", "eval", False, 0), ("sub_proto", None, True, 30)])
def test_score_report_matches_jax(tmp_path, proto, subset, per_attack, boot):
    f = _analysis_files(tmp_path)
    args = (f["a"], f[proto], "auto", subset, per_attack, boot)
    got, want = PAn.score_report(*args), JAn.score_report(*args)
    assert str(got) == str(want)
    _same(got.to_dict(), want.to_dict())
    _same(PAn.matched_scores(f["a"], f[proto], "auto", subset),
          JAn.matched_scores(f["a"], f[proto], "auto", subset))


def test_load_asv_scores_matches_jax(tmp_path):
    f = _analysis_files(tmp_path)
    _same(PAn.load_asv_scores(f["asv"]), JAn.load_asv_scores(f["asv"]))
    bad = tmp_path / "bad_asv.txt"
    bad.write_text("x spoof 1.0\n")
    for mod in (JAn, PAn):
        with pytest.raises(ValueError, match="no target/nontarget"):
            mod.load_asv_scores(str(bad))


@pytest.mark.parametrize("version,per_attack,costs", [
    ("legacy", False, None), ("legacy", True, None), ("revised", True, None),
    ("legacy", True, {"Cfa_cm": 5.0})])
def test_tdcf_report_matches_jax(tmp_path, version, per_attack, costs):
    f = _analysis_files(tmp_path)
    args = (f["a"], f["asv_proto"], f["asv"], version, "auto", None, costs, per_attack)
    got = PAn.tdcf_report(*args)
    assert got == JAn.tdcf_report(*args) and got.startswith(f"min t-DCF ({version})")


@pytest.mark.parametrize("keys,subset", [(("a", "b"), None), (("a", "b", "p"), None),
                                         (("b", "a"), "eval")])
def test_fusion_matches_jax(tmp_path, keys, subset):
    f = _analysis_files(tmp_path)
    paths = [f[k] for k in keys]
    _same(PAn.stack_scores(paths), JAn.stack_scores(paths))
    got = PAn.fit_fusion(paths, f["sub_proto"], subset=subset)
    want = JAn.fit_fusion(paths, f["sub_proto"], subset=subset)
    _same(got, want)
    w, b, _ = want
    out_p, out_j = str(tmp_path / "fused_port.txt"), str(tmp_path / "fused_jax.txt")
    assert PAn.write_fused_scores(paths, w, b, out_p) == \
        JAn.write_fused_scores(paths, w, b, out_j)
    with open(out_p) as fp, open(out_j) as fj:
        assert fp.read() == fj.read()


def test_stack_scores_needs_two_files_like_jax(tmp_path):
    f = _analysis_files(tmp_path)
    for mod in (JAn, PAn):
        with pytest.raises(ValueError, match="at least 2"):
            mod.stack_scores([f["a"]])


@pytest.mark.parametrize("proto,subset", [("asv_proto", None), ("sub_proto", "dev")])
def test_paired_system_scores_match_jax(tmp_path, proto, subset):
    f = _analysis_files(tmp_path)
    args = (f["a"], f["b"], f[proto], "auto", subset)
    _same(PAn.paired_system_scores(*args), JAn.paired_system_scores(*args))


@pytest.mark.parametrize("plot", ["plot_score_distributions", "plot_det_curve"])
def test_plots_write_a_figure_like_jax(tmp_path, plot):
    tar, non = _scores(61)
    for mod, name in ((JAn, "jax.png"), (PAn, "port.png")):
        path = str(tmp_path / name)
        assert getattr(mod, plot)(tar, non, path) == path
        assert os.path.getsize(path) > 1000
