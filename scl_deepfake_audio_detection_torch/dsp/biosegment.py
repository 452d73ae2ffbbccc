"""Breathing / talking / silence ("bio") tokens of raw waveforms.

Counterpart of ``scl_deepfake_audio_detection_tpu/dsp/biosegment.py``, the
energy-band segmenter the BTSE model conditions on (the reference's own
segmenter is an empty directory in its snapshot).  Tensor ops on the
input's device, so the tokens of a batch on the card are computed there:

- frames of 20 ms (320 samples at 16 kHz), no overlap; trailing samples
  that do not fill a frame are dropped (a 64600-sample crop gives 201
  tokens, a 64000-sample training view 200);
- per-frame energy e = 20 * log10(std(frame) + 1e-8) in fp32, the
  population std (no Bessel correction, as ``jnp.std``);
- tokens against the utterance's peak energy: TALKING above peak - 30 dB,
  SILENCE below peak - 55 dB, BREATHING in between.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.utils.device import resolve_device

N_BIOS = 3
SILENCE, TALKING, BREATHING = 0, 1, 2


def num_bio_tokens(num_samples: int, sr: int = 16000, hop_ms: float = 20.0) -> int:
    """Token count of a ``num_samples`` input."""
    return num_samples // int(sr * hop_ms / 1000.0)


def frame_energy_db(wav: torch.Tensor, sr: int = 16000,
                    hop_ms: float = 20.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., T_samples] -> (fp32 energies [..., T_bio] in dB, each
    utterance's peak [..., 1])."""
    hop = int(sr * hop_ms / 1000.0)
    n = (wav.shape[-1] // hop) * hop
    frames = wav[..., :n].reshape(*wav.shape[:-1], n // hop, hop)
    e = 20.0 * torch.log10(torch.std(frames.float(), dim=-1, correction=0) + 1e-8)
    return e, e.amax(dim=-1, keepdim=True)


def wav2bio(wav: torch.Tensor, sr: int = 16000, hop_ms: float = 20.0,
            upper_db: float = 30.0, lower_db: float = 55.0) -> torch.Tensor:
    """[..., T_samples] -> int32 bio tokens [..., T_bio], batched."""
    e, peak = frame_energy_db(wav, sr, hop_ms)
    tokens = torch.where(e > peak - upper_db, TALKING,
                         torch.where(e < peak - lower_db, SILENCE, BREATHING))
    return tokens.to(torch.int32)


def wav2bio_np(wav: np.ndarray, sr: int = 16000,
               device: Optional[Union[str, torch.device]] = None, **kw) -> np.ndarray:
    """Host wrapper of ``wav2bio``: numpy in, int32 numpy out, the tokens
    computed on ``device`` (the card unless ``device="cpu"``)."""
    x = torch.as_tensor(np.asarray(wav), device=resolve_device(device))
    return wav2bio(x, sr=sr, **kw).cpu().numpy()
