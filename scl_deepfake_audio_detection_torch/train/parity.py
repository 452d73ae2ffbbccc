"""Score parity against a reference score file (``--parity_check``).

Counterpart of ``scl_deepfake_audio_detection_tpu/train/parity.py``: score
the utterances of a committed reference score file that exist under the
database through the path ``--eval`` takes (EvalDataset -> EvalLoader ->
``score_step`` on the matmul weights cast to the compute dtype) and diff the
bonafide score row by row, with a pass/fail tolerance.  With the
reference's conf-3 ``epoch_N.pth`` (``--model_path``) and its LA19 score
file, this is the check of the published EERs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.train.analysis import load_scores


@dataclass
class ParityReport:
    n_reference: int  # rows in the reference score file
    n_scored: int  # rows scored (audio present on disk)
    max_abs: float
    mean_abs: float
    n_over_tol: int
    tol: float
    worst: List[str] = field(default_factory=list)  # "utt ours ref diff" rows

    @property
    def ok(self) -> bool:
        return self.n_scored > 0 and self.n_over_tol == 0

    def __str__(self) -> str:
        head = (f"parity: {self.n_scored}/{self.n_reference} reference rows scored; "
                f"max|d|={self.max_abs:.6f} mean|d|={self.mean_abs:.6f} "
                f"({self.n_over_tol} rows over tol {self.tol:g}) -> "
                f"{'PASS' if self.ok else 'FAIL'}")
        if self.worst and not self.ok:
            head += "\n  worst rows (utt ours ref diff):\n    " + "\n    ".join(self.worst)
        return head


def run_parity_check(model, reference_scores: str, database_path: str, *,
                     use_eval_subdir: bool = True, padding_type: str = "zero",
                     fmt: str = "auto", n: int = 200, tol: float = 1e-2,
                     batch_size: int = 8, num_workers: int = 2,
                     compute_dtype: str = "float32", score_fn=None) -> ParityReport:
    """Score up to ``n`` utterances of ``reference_scores`` that exist under
    ``database_path`` and diff the bonafide score against the reference's
    (column 1 of a pred-format file, ``cm1`` of an eval-format file).

    ``score_fn``: wav [B, T] -> [B, 2] scores; by default ``score_step`` of
    ``model`` with its matmul weights cast to ``compute_dtype`` (in place),
    the CLI eval mode's closure."""
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.data.loader import EvalLoader
    from scl_deepfake_audio_detection_torch.models.base import cast_matmul_params
    from scl_deepfake_audio_detection_torch.train.engine import score_step
    from scl_deepfake_audio_detection_torch.utils.device import torch_dtype

    ref = load_scores(reference_scores, fmt=fmt)
    base = os.path.join(database_path, "eval") if use_eval_subdir else database_path
    present = [u for u in ref if os.path.exists(os.path.join(base, u))]
    subset = present[: max(n, 1)] if n else present
    if not subset:
        return ParityReport(n_reference=len(ref), n_scored=0, max_abs=float("nan"),
                            mean_abs=float("nan"), n_over_tol=0, tol=tol,
                            worst=[f"no scored utterances found under {base}"])
    ds = EvalDataset(subset, database_path, padding_type=padding_type,
                     use_eval_subdir=use_eval_subdir)
    loader = EvalLoader(ds, batch_size=batch_size, num_workers=num_workers)
    if score_fn is None:
        cast = cast_matmul_params(model.eval(), torch_dtype(compute_dtype))

        def score_fn(wav):
            return score_step(cast, wav)

    ours: Dict[str, float] = {}
    for wav, utt_ids in loader:  # the final batch is padded; zip drops the pad rows
        lp = np.asarray(torch.as_tensor(score_fn(wav)).float().cpu())
        for u, row in zip(utt_ids, lp):
            ours[u] = float(row[1])  # the bonafide log-prob is the reference's score
    diffs = np.array([ours[u] - ref[u] for u in subset])
    order = np.argsort(-np.abs(diffs))
    worst = [f"{subset[i]} {ours[subset[i]]:+.6f} {ref[subset[i]]:+.6f} {diffs[i]:+.6f}"
             for i in order[:5]]
    return ParityReport(n_reference=len(ref), n_scored=len(subset),
                        max_abs=float(np.abs(diffs).max()),
                        mean_abs=float(np.abs(diffs).mean()),
                        n_over_tol=int((np.abs(diffs) > tol).sum()), tol=tol, worst=worst)
