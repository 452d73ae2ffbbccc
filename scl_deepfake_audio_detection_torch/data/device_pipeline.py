"""SCL view batches composed on the device.

Counterpart of ``scl_deepfake_audio_detection_tpu/data/device_pipeline.py``.
The host path builds each 11-view anchor group in numpy on worker threads
(``data/datasets.SCLViewBatchBuilder.build``).  Here the host only decodes
and co-crops (``build_raw``), and the conf-3 augmentation list (RawBoost12,
background noise at a random SNR, RIR reverb) runs over the whole [G, V, T]
batch on the composer's device:

  inputs     anchors [G, T], additional reals [G, n_real, T], vocoded
             [G, n_voc, T], additional spoofs [G, n_spoof, T] (float32 in
             [-1, 1], or the int16 PCM wire), the noise bank [N, T_noise]
             and RIR bank [M, T_rir], resident on the device across steps
  on device  RawBoost LnL + ISD (``dsp/rawboost_batched``), noise mixing
             over random bank crops, FFT reverb with a random RIR, labels

``snr_mode``:

- 'reference' (default) is the host and reference distribution: pydub's
  gain ``SNR_dB * noise_dBFS / signal_dBFS`` applied to the signal with the
  noise overlaid unscaled (``audio_augmentor/background_noise.py:45-56``),
  an integer SNR in [5, 15] dB, and the int16-amplitude round trip of
  ``audio_augmentor/utils.py:20-23`` on the noise and reverb views;
- 'rms' is the textbook RMS-power mix at signal scale, a different
  distribution.

Views follow the dataset variant's recipe (``compose_views_given``).  Pitch,
speed and telephone stay on the host path.

Every random step is split into draws (``draw_views``, from a
``torch.Generator``) and a pure step that takes them (``compose_views_given``),
so a test can hand it the JAX package's own draws.  The two packages draw
different streams; the distributions match.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.dsp import rawboost_batched as RBB
from scl_deepfake_audio_detection_torch.ops.layers import dewire_pcm16
from scl_deepfake_audio_detection_torch.utils.config import RawBoostConfig

_I16 = 32768.0
SNR_MODES = ("reference", "rms")


def mix_noise_at_snr(wav: torch.Tensor, noise: torch.Tensor,
                     snr_db: torch.Tensor) -> torch.Tensor:
    """wav + gain * noise at a per-row RMS-power SNR in dB (``snr_mode``
    'rms', not the reference's formula)."""
    pw = (wav ** 2).mean(dim=-1, keepdim=True)
    pn = (noise ** 2).mean(dim=-1, keepdim=True) + 1e-12
    gain = torch.sqrt(pw / (pn * 10.0 ** (snr_db / 10.0)))
    return wav + gain * noise


def mix_noise_pydub(wav: torch.Tensor, noise: torch.Tensor,
                    snr_db: torch.Tensor) -> torch.Tensor:
    """The reference's MUSAN overlay (``snr_mode`` 'reference'): both sides
    truncated to int16 amplitude as ``(x * 2**15).astype(int16)`` does, the
    signal scaled by ``snr_db * noise_dBFS / signal_dBFS`` dB, the noise
    added unscaled, clipped to int16.  Inputs in [-1, 1]; the output is at
    int16 amplitude, like the host path's ``background_noise``.  A silent
    noise row (the missing-``noise_path`` bank) passes the signal through."""
    sig = torch.trunc(wav * _I16)
    nse = torch.trunc(noise * _I16)

    def rms(x):
        return torch.sqrt((x ** 2).mean(dim=-1, keepdim=True))

    def dbfs(x):  # pydub's AudioSegment.dBFS
        return 20.0 * torch.log10(torch.clamp(rms(x), min=1e-6) / _I16)

    gain_db = snr_db * dbfs(nse) / dbfs(sig)
    out = sig * 10.0 ** (gain_db / 20.0) + nse
    out = torch.where(rms(nse) > 0.0, out, sig)
    return torch.clamp(out, -_I16, _I16 - 1.0)


def fft_reverb(wav: torch.Tensor, rir: torch.Tensor) -> torch.Tensor:
    """[..., T] convolved with [..., T_rir] by FFT, divided by the peak of
    the whole convolution (as the host's ``dsp/augment.reverb`` and the
    reference's ``reverb.py:33-46``), then cut to T."""
    t, tr = wav.shape[-1], rir.shape[-1]
    n = t + tr
    y = torch.fft.irfft(torch.fft.rfft(wav, n, dim=-1) * torch.fft.rfft(rir, n, dim=-1),
                        n, dim=-1)
    peak = y[..., :t + tr - 1].abs().amax(dim=-1, keepdim=True) + 1e-12
    return y[..., :t] / peak


def bank_rows(bank: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
              length: int) -> torch.Tensor:
    """Crops [rows, length] of ``bank`` [N, T_bank]: row ``idx[i]`` from
    ``starts[i]``, clamped as ``lax.dynamic_slice`` clamps."""
    if bank.shape[1] < length:
        raise ValueError(f"bank rows of {bank.shape[1]} samples are shorter than "
                         f"the {length}-sample crop")
    starts = starts.clamp(0, bank.shape[1] - length)
    cols = starts[:, None] + torch.arange(length, device=bank.device)
    return bank[idx[:, None], cols]


@dataclass
class AugDraws:
    """The draws of the three device augmentations over R rows: ISD for
    RawBoost, the noise crops (``noise_idx``, ``noise_start`` [R]), the SNR
    [R, 1], the RIR rows ``rir_idx`` [R], and for a random choice per row
    ``choice`` [R, 1] in {0, 1, 2} (RawBoost, noise, reverb)."""

    isd: RBB.IsdDraws
    noise_idx: torch.Tensor
    noise_start: torch.Tensor
    snr: torch.Tensor
    rir_idx: torch.Tensor
    choice: Optional[torch.Tensor] = None


def draw_augment(r: int, t: int, noise_bank: torch.Tensor, rir_bank: torch.Tensor,
                 cfg: RawBoostConfig, snr_mode: str, generator: Optional[torch.Generator],
                 choice: bool = False) -> AugDraws:
    dev = noise_bank.device

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=generator, device=dev)

    isd = RBB.draw_isd(r, t, cfg.P, generator, dev)
    noise_idx = randint(noise_bank.shape[0], (r,))
    noise_start = randint(max(noise_bank.shape[1] - t + 1, 1), (r,))
    if snr_mode == "reference":  # random.randint(5, 15): both ends included
        snr = randint(16 - 5, (r, 1)).float() + 5.0
    elif snr_mode == "rms":
        snr = 5.0 + 10.0 * torch.rand((r, 1), generator=generator, device=dev)
    else:
        raise ValueError(f"unknown snr_mode {snr_mode!r}")
    rir_idx = randint(rir_bank.shape[0], (r,))
    return AugDraws(isd, noise_idx, noise_start, snr, rir_idx,
                    randint(3, (r, 1)) if choice else None)


def augment_all_given(x: torch.Tensor, chains: torch.Tensor, noise_bank: torch.Tensor,
                      rir_bank: torch.Tensor, d: AugDraws, cfg: RawBoostConfig,
                      snr_mode: str = "reference"):
    """x [R, T] -> (rawboosted, noisy, reverbed), each [R, T], from given
    draws.  In 'reference' mode the noise and reverb views come out at int16
    amplitude, and the reverb's +1.0 peak sample wraps to -32768 as the
    reference's ``(y * 32768).astype(int16)`` overflows; RawBoost stays at
    signal scale in both modes."""
    r, t = x.shape
    rb = RBB.isd_given(RBB.lnl_convolutive_noise(x, chains), d.isd.beta, d.isd.u_mask,
                       d.isd.f1, d.isd.f2, cfg.g_sd)
    noise = bank_rows(noise_bank, d.noise_idx, d.noise_start, t)
    rirs = rir_bank[d.rir_idx]
    if snr_mode == "reference":
        noisy = mix_noise_pydub(x, noise, d.snr.to(x.dtype))
        reverbed = torch.trunc(fft_reverb(x, rirs) * _I16)
        reverbed = torch.where(reverbed >= _I16, reverbed - 2.0 * _I16, reverbed)
    elif snr_mode == "rms":
        noisy = mix_noise_at_snr(x, noise, d.snr.to(x.dtype))
        reverbed = fft_reverb(x, rirs)
    else:
        raise ValueError(f"unknown snr_mode {snr_mode!r}")
    return rb, noisy, reverbed


def augment_random_given(x, chains, noise_bank, rir_bank, d: AugDraws,
                         cfg: RawBoostConfig, snr_mode: str = "reference") -> torch.Tensor:
    """One of the three augmentations per row, by ``d.choice`` (the aug_2 and
    scl_normal "random method per view"): all three run, the row's is kept."""
    rb, noisy, reverbed = augment_all_given(x, chains, noise_bank, rir_bank, d, cfg,
                                            snr_mode)
    return torch.where(d.choice == 0, rb, torch.where(d.choice == 1, noisy, reverbed))


def _role_rows(variant: str, g: int, n_real: int, n_voc: int, n_spoof: int) -> Dict:
    """Which roles a variant augments, and how: 'all' (the three views per
    row), 'random' (one per row) or 'isd' (RawBoost only), with the row
    count of each."""
    if variant in ("augall_3", "augall_5"):
        return {"anchor": ("all", g), "vocoded": ("isd", g * n_voc)}
    if variant == "aug_2":
        return {"anchor": ("all", g), "reals": ("random", g * n_real),
                "vocoded": ("random", g * n_voc)}
    if variant == "scl_normal":
        return {"anchor": ("all", g), "reals": ("random", g * n_real),
                "spoofs": ("random", g * n_spoof)}
    if variant == "xinwang":
        return {"anchor": ("all", g), "vocoded": ("all", g * n_voc)}
    raise ValueError(f"unknown variant {variant!r}")


def draw_views(g: int, n_real: int, n_voc: int, n_spoof: int, t: int,
               noise_bank: torch.Tensor, rir_bank: torch.Tensor, cfg: RawBoostConfig,
               variant: str, snr_mode: str, generator: Optional[torch.Generator]) -> Dict:
    """The draws ``compose_views_given`` takes, by role."""
    out = {}
    for role, (how, rows) in _role_rows(variant, g, n_real, n_voc, n_spoof).items():
        if how == "isd":
            out[role] = RBB.draw_isd(rows, t, cfg.P, generator, noise_bank.device)
        else:
            out[role] = draw_augment(rows, t, noise_bank, rir_bank, cfg, snr_mode,
                                     generator, choice=how == "random")
    return out


def compose_views_given(anchors, reals, vocoded, spoofs, noise_bank: torch.Tensor,
                        rir_bank: torch.Tensor, lnl_chains: torch.Tensor, draws: Dict,
                        cfg: RawBoostConfig, variant: str = "augall_3",
                        snr_mode: str = "reference") -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (views [G, V, T] fp32, labels [G, V]) from given draws, per dataset
    variant (the reference's ``datautils/*`` recipes):

    - augall_3, augall_5: anchor, [rb, noise, reverb](anchor), reals ||
      vocoded, rb(vocoded), spoofs
    - aug_2: anchor, all3(anchor), reals, rand(reals) || vocoded, rand(vocoded)
    - scl_normal: anchor, all3(anchor), reals, rand(reals) || spoofs,
      rand(spoofs)
    - xinwang: anchor, all3(anchor) || vocoded, all3(vocoded)

    ``lnl_chains`` [G * (1 + n_voc + n_real + n_spoof), n_f, NB] holds the
    rows of each role in that order.  Waveforms may be int16 PCM."""
    anchors, reals, vocoded, spoofs = map(dewire_pcm16, (anchors, reals, vocoded, spoofs))
    g, t = anchors.shape
    n_real, n_voc, n_spoof = reals.shape[1], vocoded.shape[1], spoofs.shape[1]
    c_anchor = lnl_chains[:g]
    c_voc = lnl_chains[g:g + g * n_voc]
    c_real = lnl_chains[g + g * n_voc:g + g * n_voc + g * n_real]
    c_spoof = lnl_chains[g + g * n_voc + g * n_real:]

    def flat(x):
        return x.reshape(-1, t)

    def rand(x, chains, d, n):
        return augment_random_given(flat(x), chains, noise_bank, rir_bank, d, cfg,
                                    snr_mode).reshape(g, n, t)

    aug3_anchor = torch.stack(augment_all_given(anchors, c_anchor, noise_bank, rir_bank,
                                                draws["anchor"], cfg, snr_mode), dim=1)
    if variant in ("augall_3", "augall_5"):
        d = draws["vocoded"]
        rb_voc = RBB.isd_given(RBB.lnl_convolutive_noise(flat(vocoded), c_voc), d.beta,
                               d.u_mask, d.f1, d.f2, cfg.g_sd).reshape(g, n_voc, t)
        pos = [anchors[:, None], aug3_anchor, reals]
        neg = [vocoded, rb_voc, spoofs]
    elif variant == "aug_2":
        pos = [anchors[:, None], aug3_anchor, reals,
               rand(reals, c_real, draws["reals"], n_real)]
        neg = [vocoded, rand(vocoded, c_voc, draws["vocoded"], n_voc)]
    elif variant == "scl_normal":
        pos = [anchors[:, None], aug3_anchor, reals,
               rand(reals, c_real, draws["reals"], n_real)]
        neg = [spoofs, rand(spoofs, c_spoof, draws["spoofs"], n_spoof)]
    elif variant == "xinwang":
        aug3_voc = torch.stack(augment_all_given(flat(vocoded), c_voc, noise_bank, rir_bank,
                                                 draws["vocoded"], cfg, snr_mode), dim=1)
        pos = [anchors[:, None], aug3_anchor]
        neg = [vocoded, aug3_voc.reshape(g, 3 * n_voc, t)]
    else:
        raise ValueError(f"unknown variant {variant!r}")
    pos_t, neg_t = torch.cat(pos, dim=1), torch.cat(neg, dim=1)
    views = torch.cat([pos_t, neg_t], dim=1).float()
    labels = torch.cat([torch.ones(g, pos_t.shape[1], device=views.device),
                        torch.zeros(g, neg_t.shape[1], device=views.device)], dim=1)
    return views, labels


def compose_views(anchors, reals, vocoded, spoofs, noise_bank: torch.Tensor,
                  rir_bank: torch.Tensor, lnl_chains: torch.Tensor,
                  generator: Optional[torch.Generator], cfg: RawBoostConfig,
                  variant: str = "augall_3", snr_mode: str = "reference"):
    """``compose_views_given`` with draws from ``generator``."""
    g, t = anchors.shape
    draws = draw_views(g, reals.shape[1], vocoded.shape[1], spoofs.shape[1], t, noise_bank,
                       rir_bank, cfg, variant, snr_mode, generator)
    return compose_views_given(anchors, reals, vocoded, spoofs, noise_bank, rir_bank,
                               lnl_chains, draws, cfg, variant, snr_mode)


def mix_seed(*words: int) -> int:
    """A well-mixed 64-bit seed from integer words."""
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0])


class DeviceViewComposer:
    """Owns the noise and RIR banks and a pool of notch chains on its
    device; called with a step's raw host arrays and the step's seed, it
    returns the composed batch there.

    The pool is designed once on the host from ``np.random.default_rng(seed)``
    (the JAX composer's pool, bit for bit).  Each step picks pool rows and
    draws its augmentations from generators seeded from the step's seed
    alone, so a dev pass composes the same views every epoch and across
    resumes."""

    def __init__(self, cfg: RawBoostConfig, noise_bank: np.ndarray, rir_bank: np.ndarray,
                 fs: int = 16000, nb: int = 1024, seed: int = 0, pool_size: int = 256,
                 snr_mode: str = "reference", device="cuda"):
        from scl_deepfake_audio_detection_torch.utils.device import resolve_device

        if snr_mode not in SNR_MODES:
            raise ValueError(f"unknown snr_mode {snr_mode!r}")
        self.device = resolve_device(device)
        self.cfg, self.snr_mode, self.fs, self.nb = cfg, snr_mode, fs, nb
        to = dict(device=self.device, dtype=torch.float32)
        self.noise_bank = torch.as_tensor(np.asarray(noise_bank, np.float32)).to(**to)
        self.rir_bank = torch.as_tensor(np.asarray(rir_bank, np.float32)).to(**to)
        host_rng = np.random.default_rng(seed)
        pool = np.stack([RBB.pack_chains(RBB.design_lnl_chains(cfg, fs, host_rng), nb)
                         for _ in range(pool_size)]).astype(np.float32)
        self.chain_pool = torch.from_numpy(pool).to(self.device)  # [pool, n_f, NB]

    def generators(self, step_seed: int) -> Tuple[torch.Generator, torch.Generator]:
        """(chain-row generator, augmentation generator) of one step."""
        def gen(*words):
            return torch.Generator(device=self.device).manual_seed(mix_seed(step_seed, *words))

        return gen(0x5C1C), gen(0)

    def __call__(self, anchors, reals, vocoded, step_seed: int, spoofs=None,
                 variant: str = "augall_3") -> Tuple[torch.Tensor, torch.Tensor]:
        def on_device(x):
            return torch.as_tensor(x).to(self.device, non_blocking=True)

        anchors, reals, vocoded = map(on_device, (anchors, reals, vocoded))
        g, t = anchors.shape
        spoofs = (torch.zeros((g, 0, t), dtype=anchors.dtype, device=self.device)
                  if spoofs is None else on_device(spoofs))
        n_rows = g * (1 + vocoded.shape[1] + reals.shape[1] + spoofs.shape[1])
        idx_gen, aug_gen = self.generators(step_seed)
        idx = torch.randint(0, self.chain_pool.shape[0], (n_rows,), generator=idx_gen,
                            device=self.device)
        return compose_views(anchors, reals, vocoded, spoofs, self.noise_bank, self.rir_bank,
                             self.chain_pool[idx], aug_gen, self.cfg, variant, self.snr_mode)


def build_banks(noise_path: Optional[str], rir_path: Optional[str], sr: int = 16000,
                bank_len: int = 128000, rir_len: int = 8000,
                max_files: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Decode the noise and RIR trees into fixed-shape banks: [N, bank_len]
    noise (tiled, then cut) and [M, rir_len] RIRs (zero-padded).  A missing
    or empty tree gives one silent noise row or one identity RIR, so the
    augmentation degrades to a near no-op rather than an error."""
    from scl_deepfake_audio_detection_torch.data.augment_registry import list_audio_files
    from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio

    def rows(path, length, tile, empty_row):
        files = list_audio_files(path)[:max_files] if path else []
        out = []
        for f in files:
            try:
                w = load_audio(f, sr)
            except Exception:
                continue
            if tile and len(w) < length:
                w = np.tile(w, length // max(len(w), 1) + 1)
            row = np.zeros(length, np.float32)
            row[:min(len(w), length)] = w[:length]
            out.append(row)
        return np.stack(out or [empty_row])

    silent = np.zeros(bank_len, np.float32)
    delta = np.zeros(rir_len, np.float32)
    delta[0] = 1.0
    return rows(noise_path, bank_len, True, silent), rows(rir_path, rir_len, False, delta)
