"""Eval dataset and the dataset-name -> database-layout table.

Counterpart of ``EvalDataset`` and the ``_VARIANTS`` registry in
``scl_deepfake_audio_detection_tpu/data/datasets.py``: the data name of a
config decides between the SCL layout (``scp/test.lst`` + ``eval/``) and the
eval-only layout (``protocol.txt`` + audio at the database root).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from scl_deepfake_audio_detection_torch.dsp.pad import pad_eval
from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio

# variant None = eval-only layout; eval_subdir = audio under <base>/eval/
LAYOUTS: Dict[str, Dict] = {
    "asvspoof_2019_augall_3": {"variant": "augall_3", "eval_subdir": True},
    "asvspoof_2019_aug_2": {"variant": "aug_2", "eval_subdir": True},
    "asvspoof_2019_augall_5": {"variant": "augall_5", "eval_subdir": True},
    "SCL_normal": {"variant": "scl_normal", "eval_subdir": True},
    "asvspoof_2019_xinwang": {"variant": "xinwang", "eval_subdir": True},
    "eval_only": {"variant": None, "eval_subdir": False},
}


def layout(data_name: str) -> Dict:
    if data_name not in LAYOUTS:
        raise KeyError(f"unknown dataset {data_name!r}; known: {sorted(LAYOUTS)}")
    return LAYOUTS[data_name]


class EvalDataset:
    """Fixed-length eval items: audio from ``<base>/eval/<utt>`` (SCL
    layout) or ``<base>/<utt>`` (eval-only layout), truncated or padded to
    ``cut`` samples."""

    def __init__(self, file_list: Sequence[str], base_dir: str,
                 padding_type: str = "zero", cut: int = 64600,
                 use_eval_subdir: bool = True, sample_rate: int = 16000):
        self.files = list(file_list)
        self.base_dir = os.path.join(base_dir, "eval") if use_eval_subdir else base_dir
        self.padding_type = padding_type
        self.cut = cut
        self.sample_rate = sample_rate

    def __len__(self) -> int:
        return len(self.files)

    def get(self, idx: int) -> Tuple[np.ndarray, str]:
        utt = self.files[idx]
        wav = load_audio(os.path.join(self.base_dir, utt), self.sample_rate)
        return pad_eval(wav, self.padding_type, self.cut).astype(np.float32), utt
