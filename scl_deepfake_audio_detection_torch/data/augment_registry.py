"""Named augmentation methods: the wrappers that YAML configs name.

Counterpart of ``scl_deepfake_audio_detection_tpu/data/augment_registry.py``.
The reference resolves ``augmentation_methods`` entries to functions through
``globals()`` of each dataset module, and each wrapper caches on its own
(``datautils/asvspoof_2019_augall_3.py:166-374``).  Here every method is a
registry entry with one signature::

    fn(wav, rng, res, utt_id=None) -> np.ndarray

and caching is one code path: offline mode stores and reads PCM16 WAVs at
``aug_dir/<method>/<basename of utt_id>`` as the reference does, so the
offline round trip returns [-1, 1] floats while the online pydub-family
methods return int16-scale floats: the reference trains with that asymmetry.
Names keep the reference spelling (``RawBoost12``,
``background_noise_wrapper``, ...).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from scl_deepfake_audio_detection_torch.dsp import augment as A
from scl_deepfake_audio_detection_torch.dsp.rawboost import process_rawboost
from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio, save_wav
from scl_deepfake_audio_detection_torch.utils.config import RawBoostConfig
from scl_deepfake_audio_detection_torch.utils.registry import AUGMENTATIONS

_AUDIO_EXTS = (".wav", ".mp3", ".flac")

#: (aug_dir, method, basename) -> the first source path that asked for it
_CACHE_SOURCES: dict = {}


def list_audio_files(path: str) -> List[str]:
    """Recursive, sorted audio listing (reference ``audio_augmentor/utils.py:10-18``)."""
    out = []
    for dirpath, _dirs, files in os.walk(path):
        for f in files:
            if f.lower().endswith(_AUDIO_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


@dataclass
class AugmentResources:
    """What the wrappers share: RawBoost knobs, the rate, the noise and RIR
    trees, the offline cache (the reference passes them in its argparse
    ``args``, ``asvspoof_2019_augall_3.py:73-77``)."""

    rawboost: RawBoostConfig = field(default_factory=RawBoostConfig)
    sample_rate: int = 16000
    noise_path: Optional[str] = None
    rir_path: Optional[str] = None
    aug_dir: Optional[str] = None
    online: bool = True
    _noise_files: Optional[List[str]] = None
    _rir_files: Optional[List[str]] = None

    @property
    def noise_files(self) -> List[str]:
        if self._noise_files is None:
            if not self.noise_path:
                raise ValueError("background_noise requires noise_path (MUSAN)")
            self._noise_files = list_audio_files(self.noise_path)
        return self._noise_files

    @property
    def rir_files(self) -> List[str]:
        if self._rir_files is None:
            if not self.rir_path:
                raise ValueError("reverb requires rir_path (RIRS_NOISES)")
            self._rir_files = list_audio_files(self.rir_path)
        return self._rir_files


def _cached(method: str, int16_scale: bool = False):
    """Wrap a compute function with the reference's offline cache.

    ``int16_scale`` says the function returns int16-scale floats (the
    pydub family), which the cache stores divided by 32768.  Offline, the
    cache file is read on a hit and on a miss alike (reference
    ``asvspoof_2019_augall_3.py:284-291``), so every epoch, the one that
    fills the cache included, sees the same PCM16 round-tripped audio."""

    def deco(fn: Callable) -> Callable:
        def wrapper(wav, rng, res: AugmentResources, utt_id: Optional[str] = None):
            if res.online or not res.aug_dir or not utt_id:
                return fn(wav, rng, res)
            base = os.path.basename(utt_id)
            # the cache is keyed by basename: two sources that share one
            # would read each other's audio, so that fails here instead
            prev = _CACHE_SOURCES.setdefault(
                (os.path.abspath(res.aug_dir), method, base), str(utt_id))
            if prev != str(utt_id):
                raise ValueError(
                    f"offline aug cache collision: {method}/{base} requested "
                    f"for both {prev!r} and {utt_id!r}; use distinct file "
                    "names or separate aug_dir trees")
            cache = os.path.join(res.aug_dir, method, base)
            if not os.path.exists(cache):
                out = fn(wav, rng, res)
                save_wav(cache, out / 32768.0 if int16_scale else out, res.sample_rate)
            return load_audio(cache, res.sample_rate)

        wrapper.__name__ = method
        wrapper.cache_method = method
        return wrapper

    return deco


@AUGMENTATIONS.register("RawBoost12")
@_cached("RawBoost12")
def rawboost12(wav, rng, res):
    """LnL convolutive then ISD impulsive noise (algorithm 5)."""
    return process_rawboost(wav, res.sample_rate, res.rawboost, rng, algo=5)


def _make_rawboost(name: str, algo: int):
    @_cached(name)
    def fn(wav, rng, res, _algo=algo):
        return process_rawboost(wav, res.sample_rate, res.rawboost, rng, algo=_algo)

    AUGMENTATIONS.register(name)(fn)
    return fn


for _name, _algo in [
    ("RawBoost1", 1), ("RawBoost2", 2), ("RawBoost3", 3), ("RawBoost123", 4),
    ("RawBoost13", 6), ("RawBoost23", 7), ("RawBoostPar12", 8),
]:
    _make_rawboost(_name, _algo)


@AUGMENTATIONS.register("background_noise_wrapper", aliases=("background_noise",))
@_cached("background_noise", int16_scale=True)
def background_noise_wrapper(wav, rng, res):
    noise_file = res.noise_files[int(rng.integers(len(res.noise_files)))]
    return A.background_noise(wav, load_audio(noise_file, res.sample_rate), rng)


@AUGMENTATIONS.register("reverb_wrapper", aliases=("reverb",))
@_cached("reverb", int16_scale=True)
def reverb_wrapper(wav, rng, res):
    rir_file = res.rir_files[int(rng.integers(len(res.rir_files)))]
    return A.reverb(wav, load_audio(rir_file, res.sample_rate))


@AUGMENTATIONS.register("pitch_wrapper", aliases=("pitch",))
@_cached("pitch", int16_scale=True)
def pitch_wrapper(wav, rng, res):
    return A.pitch_shift(wav, rng, sr=res.sample_rate)


@AUGMENTATIONS.register("speed_wrapper", aliases=("speed",))
@_cached("speed", int16_scale=True)
def speed_wrapper(wav, rng, res):
    return A.speed(wav, rng)


@AUGMENTATIONS.register("volume_wrapper", aliases=("volume",))
@_cached("volume", int16_scale=True)
def volume_wrapper(wav, rng, res):
    return A.volume(wav, rng)


@AUGMENTATIONS.register("gaussian_wrapper", aliases=("gaussian",))
@_cached("gaussian", int16_scale=True)
def gaussian_wrapper(wav, rng, res):
    return A.gaussian_noise(wav, rng)


@AUGMENTATIONS.register("time_mask")
def time_mask_wrapper(wav, rng, res, utt_id=None):
    return A.time_mask(wav, rng, sr=res.sample_rate)


@AUGMENTATIONS.register("freq_mask")
def freq_mask_wrapper(wav, rng, res, utt_id=None):
    return A.freq_mask(wav, rng, sr=res.sample_rate)


@AUGMENTATIONS.register("telephone_wrapper", aliases=("telephone",))
@_cached("telephone")
def telephone_wrapper(wav, rng, res):
    """Telephone channel: 300-3400 Hz band-pass and a G.711 companding
    round trip, the law drawn from ``rng`` (``dsp/codec.telephone_effect``)."""
    from scl_deepfake_audio_detection_torch.dsp.codec import telephone_effect

    law = "alaw" if rng.integers(2) == 0 else "ulaw"
    return telephone_effect(wav, sr=res.sample_rate, encoding=law)


@AUGMENTATIONS.register("codec_wrapper", aliases=("codec",))
@_cached("codec")
def codec_wrapper(wav, rng, res):
    """Lossy codec round trip (reference ``wav_codec``: a random mp3 or opus
    bitrate through the native codec library; G.711 where no codec backend
    exists, ``dsp/codec.random_codec``)."""
    from scl_deepfake_audio_detection_torch.dsp.codec import random_codec

    return random_codec(wav, rng, sr=res.sample_rate)
