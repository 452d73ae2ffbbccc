"""Offline score analysis, the in-framework replacement for ``Result.ipynb``:
the port's copy of ``scl_deepfake_audio_detection_tpu/train/analysis.py``.

Loads the two score-file formats the scoring CLI writes (the reference's,
``main.py:161-214``), joins them with a protocol, and reports EER,
confusion counts, min t-DCF and fusion fits.  Pure numpy on the host; the
plots import matplotlib when called.

Score file formats:
  eval format  (``produce_evaluation_file``): ``utt cm0 cm1`` — two
      log-softmax outputs; the bonafide score is column 2 (``cm1``).
  pred format  (``produce_prediction_file``): ``utt score pred`` — bonafide
      logit and argmax prediction; the score is column 1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from scl_deepfake_audio_detection_torch.data.protocols import parse_protocol
from scl_deepfake_audio_detection_torch.train.calibration import (
    cllr,
    fuse_scores,
    logistic_fusion,
)
from scl_deepfake_audio_detection_torch.train.metrics import (
    compute_eer,
    confusion_counts,
    det_curve,
    eer_bootstrap_ci,
    min_tdcf,
)


def load_scores(path: str, fmt: str = "auto") -> Dict[str, float]:
    """Return utt -> bonafide score.

    ``fmt``: 'eval' (utt cm0 cm1 -> score = cm1), 'pred' (utt score pred ->
    score = col 1), or 'auto' (pred if the last column parses as an integer
    class id, else eval).
    """
    utts: List[str] = []
    cols: List[Tuple[float, float]] = []
    with open(path, "r") as f:
        for ln in f:
            parts = ln.split()
            if len(parts) < 3:
                continue
            utts.append(parts[0])
            cols.append((float(parts[1]), float(parts[2])))
    if not utts:
        raise ValueError(
            f"{path}: no score rows parsed — expected at least 3 whitespace "
            "columns per line ('utt cm0 cm1' eval format or 'utt score pred')"
        )
    if fmt == "auto":
        last = np.array([c[1] for c in cols])
        fmt = "pred" if np.all(last == np.round(last)) and np.all(np.abs(last) <= 1) else "eval"
    idx = 0 if fmt == "pred" else 1
    return {u: c[idx] for u, c in zip(utts, cols)}


@dataclass
class EvalReport:
    eer: float
    threshold: float
    n_bonafide: int
    n_spoof: int
    confusion: Tuple[int, int, int, int]  # tp, tn, fp, fn at the EER threshold
    per_attack: Optional[Dict[str, Tuple[float, int]]] = None  # attack -> (eer, n)
    eer_ci: Optional[Tuple[float, float]] = None  # bootstrap 95% interval

    def to_dict(self) -> Dict:
        """JSON-ready form (CLI ``--json``)."""
        tp, tn, fp, fn = self.confusion
        d = {
            "eer": self.eer,
            "threshold": self.threshold,
            "n_bonafide": self.n_bonafide,
            "n_spoof": self.n_spoof,
            "confusion": {"tp": tp, "tn": tn, "fp": fp, "fn": fn},
        }
        if self.eer_ci is not None:
            d["eer_ci95"] = list(self.eer_ci)
        if self.per_attack:
            d["per_attack"] = {
                a: {"eer": e, "n": n} for a, (e, n) in self.per_attack.items()
            }
        return d

    def __str__(self) -> str:
        tp, tn, fp, fn = self.confusion
        s = (
            f"EER: {self.eer * 100:.4f}%, threshold: {self.threshold:.4f} "
            f"({self.n_bonafide} bonafide / {self.n_spoof} spoof; "
            f"tp={tp} tn={tn} fp={fp} fn={fn})"
        )
        if self.eer_ci is not None:
            lo, hi = self.eer_ci
            s += f"\n95% bootstrap CI: [{lo * 100:.4f}%, {hi * 100:.4f}%]"
        if self.per_attack:
            s += "\nper-attack EER (vs all bonafide):"
            for atk, (eer, n) in sorted(self.per_attack.items()):
                s += f"\n  {atk:>8s}: {eer * 100:7.4f}%  (n={n})"
        return s


def score_report(
    score_path: str,
    protocol_path: str,
    fmt: str = "auto",
    subset: Optional[str] = None,
    per_attack: bool = False,
    bootstrap_ci: int = 0,
) -> EvalReport:
    """Join a score file with a protocol and compute EER.

    Keys are matched the way ``Result.ipynb`` does: on the extension-less
    basename of the utterance (so ``LA_E_1000147.flac`` joins ``LA_E_1000147``
    and ``wav/1.wav`` joins an in-the-wild protocol's ``wav/1.wav``).

    ``per_attack`` adds the ASVspoof-style breakdown: each attack's spoof
    scores pooled against all bonafide scores (the notebook's per-system
    analysis over the protocol's attack column).
    """
    tar, non, non_by_attack = _joined_trials(
        score_path, protocol_path, fmt=fmt, subset=subset
    )
    tar_a, non_a = np.asarray(tar), np.asarray(non)
    eer, thr = compute_eer(tar_a, non_a)

    attack_report = None
    if per_attack and non_by_attack:
        attack_report = {}
        for atk, ss in sorted(non_by_attack.items()):
            a_eer, _ = compute_eer(tar_a, np.asarray(ss))
            attack_report[atk] = (float(a_eer), len(ss))

    ci = None
    if bootstrap_ci:
        ci = eer_bootstrap_ci(tar_a, non_a, n_boot=bootstrap_ci)
    return EvalReport(
        eer=eer,
        threshold=thr,
        n_bonafide=len(tar),
        n_spoof=len(non),
        confusion=confusion_counts(tar_a, non_a, thr),
        per_attack=attack_report,
        eer_ci=ci,
    )


def _joined_trials(
    score_path: str, protocol_path: str, fmt: str = "auto",
    subset: Optional[str] = None,
) -> Tuple[List[float], List[float], Dict[str, List[float]]]:
    """The one score<->protocol join (Result.ipynb semantics: keys are
    extension-less basenames): -> (bonafide, spoof, spoof-by-attack)."""
    scores = load_scores(score_path, fmt=fmt)
    trials = parse_protocol(protocol_path)
    if subset is not None:
        trials = [t for t in trials if t.subset == subset]

    def norm(u: str) -> str:
        return os.path.basename(u).split(".")[0]

    by_key = {norm(u): s for u, s in scores.items()}
    tar: List[float] = []
    non: List[float] = []
    non_by_attack: Dict[str, List[float]] = {}
    for t in trials:
        if t.label is None:
            continue
        s = by_key.get(norm(t.utt))
        if s is None:
            continue
        if t.label == 1:
            tar.append(s)
        else:
            non.append(s)
            non_by_attack.setdefault(t.attack or "unknown", []).append(s)
    return tar, non, non_by_attack


def matched_scores(
    score_path: str, protocol_path: str, fmt: str = "auto",
    subset: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(bonafide scores, spoof scores) joined like ``score_report``."""
    tar, non, _ = _joined_trials(score_path, protocol_path, fmt=fmt, subset=subset)
    return np.asarray(tar), np.asarray(non)


def load_asv_scores(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse an organizers'-format ASV score file into
    (target, nontarget, spoof) score arrays.

    The ASVspoof distribution format is whitespace columns
    ``source key score`` with key in {target, nontarget, spoof}; parsing is
    positional-flexible (the key column is detected by its values, the score
    is the last float column) so trimmed/extended variants also load."""
    keys = {"target", "nontarget", "spoof"}
    out = {k: [] for k in keys}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            key = next((p for p in parts if p in keys), None)
            if key is None:
                continue
            try:
                score = float(parts[-1])
            except ValueError:
                continue
            out[key].append(score)
    if not out["target"] or not out["nontarget"]:
        raise ValueError(
            f"{path}: no target/nontarget ASV trials parsed — expected "
            "whitespace columns containing a target/nontarget/spoof key and "
            "a trailing float score"
        )
    return (
        np.asarray(out["target"]),
        np.asarray(out["nontarget"]),
        np.asarray(out["spoof"]),
    )


def tdcf_report(
    score_path: str,
    protocol_path: str,
    asv_score_path: str,
    version: str = "legacy",
    fmt: str = "auto",
    subset: Optional[str] = None,
    costs: Optional[dict] = None,
    per_attack: bool = False,
) -> str:
    """min t-DCF of a CM score file against the organizers' ASV scores —
    the official ASVspoof ranking metric the reference never computes
    (its ``evaluate_metrics.py`` stops at EER).

    ``per_attack`` adds the per-system breakdown the challenge result
    papers report: each attack's spoof scores against all bonafide, with
    the ASV operating point held at the pooled EER threshold."""
    tar, non, non_by_attack = _joined_trials(score_path, protocol_path,
                                             fmt=fmt, subset=subset)
    bona, spoof = np.asarray(tar), np.asarray(non)
    tar_asv, non_asv, spoof_asv = load_asv_scores(asv_score_path)
    val, thr = min_tdcf(bona, spoof, tar_asv, non_asv, spoof_asv,
                        version=version, costs=costs)
    asv_eer, asv_thr = compute_eer(tar_asv, non_asv)
    out = (
        f"min t-DCF ({version}): {val:.4f} (CM threshold {thr:+.4f}; "
        f"ASV fixed at its EER point: {100*asv_eer:.4f}% @ {asv_thr:+.4f})"
    )
    if per_attack and non_by_attack:
        out += "\nper-attack min t-DCF (vs all bonafide):"
        for atk, ss in sorted(non_by_attack.items()):
            a_val, _ = min_tdcf(bona, np.asarray(ss), tar_asv, non_asv,
                                spoof_asv, version=version, costs=costs,
                                asv_threshold=asv_thr)
            out += f"\n  {atk:>8s}: {a_val:.4f}  (n={len(ss)})"
    return out


def plot_score_distributions(
    tar: np.ndarray,
    non: np.ndarray,
    out_path: str,
    threshold: Optional[float] = None,
    bins: int = 80,
    title: str = "score distributions",
) -> str:
    """Bonafide/spoof score histograms + EER threshold marker — the
    ``Result.ipynb`` distribution plot as a savable figure (headless Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.hist(non, bins=bins, alpha=0.6, density=True, label=f"spoof (n={len(non)})")
    ax.hist(tar, bins=bins, alpha=0.6, density=True,
            label=f"bonafide (n={len(tar)})")
    if threshold is not None:
        ax.axvline(threshold, linestyle="--", linewidth=1,
                   label=f"EER threshold {threshold:.3f}")
    ax.set_xlabel("bonafide score")
    ax.set_ylabel("density")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def stack_scores(
    paths: List[str], fmt: str = "auto"
) -> Tuple[List[str], np.ndarray]:
    """Align K score files on their common utterances -> (utts, [N, K]).

    Keys are extension-less basenames (the Result.ipynb join convention);
    utterances missing from any system are dropped (reported by count in
    the CLI).  Order follows the first file."""
    if len(paths) < 2:
        raise ValueError("fusion needs at least 2 score files")
    maps = []
    for p in paths:
        scores = load_scores(p, fmt=fmt)
        maps.append({os.path.basename(u).split(".")[0]: (u, s)
                     for u, s in scores.items()})
    common = [k for k in maps[0] if all(k in m for m in maps[1:])]
    utts = [maps[0][k][0] for k in common]
    stack = np.asarray([[m[k][1] for m in maps] for k in common], np.float64)
    return utts, stack


def fit_fusion(
    paths: List[str], protocol_path: str, fmt: str = "auto",
    subset: Optional[str] = None,
) -> Tuple[np.ndarray, float, dict]:
    """Fit logistic fusion weights on protocol-labeled dev scores.

    -> (weights [K], bias, report dict with per-system and fused EER/Cllr)."""
    utts, stack = stack_scores(paths, fmt=fmt)
    trials = parse_protocol(protocol_path)
    if subset is not None:
        trials = [t for t in trials if t.subset == subset]
    label_by_key = {
        os.path.basename(t.utt).split(".")[0]: t.label
        for t in trials if t.label is not None
    }
    keys = [os.path.basename(u).split(".")[0] for u in utts]
    keep = [i for i, k in enumerate(keys) if k in label_by_key]
    y = np.asarray([label_by_key[keys[i]] for i in keep])
    X = stack[keep]
    tar, non = X[y == 1], X[y == 0]
    w, b = logistic_fusion(tar, non)
    report = {"n_matched": len(keep), "n_common": len(utts), "systems": []}
    for k in range(X.shape[1]):
        eer_k, _ = compute_eer(tar[:, k], non[:, k])
        report["systems"].append({"path": paths[k], "eer": float(eer_k)})
    fused_t, fused_n = fuse_scores(tar, w, b), fuse_scores(non, w, b)
    eer_f, _ = compute_eer(fused_t, fused_n)
    report["fused"] = {"eer": float(eer_f),
                       "cllr": cllr(fused_t, fused_n)}
    return w, b, report


def write_fused_scores(
    paths: List[str], weights: np.ndarray, bias: float, out_path: str,
    fmt: str = "auto",
) -> int:
    """Apply fusion weights to K aligned score files; write 'utt llr pred'
    (pred-format, loadable by --analyze).  Returns rows written."""
    utts, stack = stack_scores(paths, fmt=fmt)
    llr = fuse_scores(stack, weights, bias)
    with open(out_path, "w") as f:
        for u, v in zip(utts, llr):
            f.write(f"{u} {v} {int(v > 0)}\n")
    return len(utts)


def plot_det_curve(
    tar: np.ndarray,
    non: np.ndarray,
    out_path: str,
    title: str = "DET curve",
) -> str:
    """DET curve on normal-deviate axes (Martin et al., Eurospeech 1997) —
    the standard detection visual; the EER sits where the curve crosses the
    diagonal.  Headless Agg figure, saved to ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import norm

    frr, far, _ = det_curve(tar, non)
    # clamp away exact 0/1 (probit is infinite there)
    eps = 0.5 / max(len(tar), len(non))
    frr = np.clip(frr, eps, 1 - eps)
    far = np.clip(far, eps, 1 - eps)
    eer, _thr = compute_eer(tar, non)

    fig, ax = plt.subplots(figsize=(5.5, 5.5))
    ax.plot(norm.ppf(far), norm.ppf(frr), linewidth=1.5)
    ax.scatter([norm.ppf(eer)], [norm.ppf(eer)], marker="o", zorder=3,
               label=f"EER {100*eer:.2f}%")
    ticks = np.array([0.001, 0.01, 0.05, 0.1, 0.2, 0.4, 0.6, 0.8])
    ax.set_xticks(norm.ppf(ticks))
    ax.set_xticklabels([f"{100*t:g}" for t in ticks])
    ax.set_yticks(norm.ppf(ticks))
    ax.set_yticklabels([f"{100*t:g}" for t in ticks])
    lim = (norm.ppf(eps * 0.9), norm.ppf(0.9))
    ax.plot(lim, lim, linestyle=":", linewidth=0.8, color="gray")
    ax.set_xlim(lim)
    ax.set_ylim(lim)
    ax.set_xlabel("false acceptance rate (%)")
    ax.set_ylabel("false rejection rate (%)")
    ax.set_title(title)
    ax.grid(True, linewidth=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def paired_system_scores(
    path_a: str, path_b: str, protocol_path: str, fmt: str = "auto",
    subset: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Trial-ALIGNED (tar_a, non_a, tar_b, non_b) for two systems scored on
    the same protocol (the input contract of ``metrics.eer_diff_bootstrap``);
    trials missing from either system are dropped."""
    utts, stack = stack_scores([path_a, path_b], fmt=fmt)
    trials = parse_protocol(protocol_path)
    if subset is not None:
        trials = [t for t in trials if t.subset == subset]
    label_by_key = {
        os.path.basename(t.utt).split(".")[0]: t.label
        for t in trials if t.label is not None
    }
    keys = [os.path.basename(u).split(".")[0] for u in utts]
    keep = np.asarray([i for i, k in enumerate(keys) if k in label_by_key])
    if keep.size == 0:
        raise ValueError("no trials matched both score files and the protocol")
    y = np.asarray([label_by_key[keys[i]] for i in keep])
    X = stack[keep]
    return X[y == 1, 0], X[y == 0, 0], X[y == 1, 1], X[y == 0, 1]
