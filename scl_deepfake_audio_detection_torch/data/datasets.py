"""SCL view-batch builders, the eval dataset, and the dataset registry.

Counterpart of ``scl_deepfake_audio_detection_tpu/data/datasets.py``.  Each
training item is one *anchor group*: a bonafide anchor, augmented copies of
it, other bonafide utterances, vocoded (re-synthesised) negatives and, in
some variants, real spoofs, all co-cropped to ``trim_length`` samples.  One
builder covers the five reference dataset modules, which differ in the
views they compose:

  variant 'augall_3'    reference ``asvspoof_2019_augall_3.py:103-146`` (conf-3)
  variant 'aug_2'       ``asvspoof_2019_aug_2.py:103-154`` (conf-2)
  variant 'augall_5'    ``asvspoof_2019_augall_5.py:106-155`` (conf-5)
  variant 'scl_normal'  ``SCL_normal.py:112-162`` (conf-1; real spoofs, no vocoders)
  variant 'xinwang'     ``asvspoof_2019_xinwang.py:98-131`` (legacy)

Labels are 1 for the anchor, its augmented copies and the other bonafide
views, 0 for every spoof view.  Every variant gives a fixed view count V.
An item's draws come from a ``np.random.Generator`` seeded with (seed,
epoch, index), in the JAX package's order, so both build the same batch.

``DATASETS`` maps the reference's dataset-module names to descriptors: the
variant (None for the eval-only layout), whether eval audio lies under
``eval/``, and the variant's ``repeat_pad`` where it is not the default.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scl_deepfake_audio_detection_torch.data.augment_registry import AugmentResources
from scl_deepfake_audio_detection_torch.dsp.pad import multiview_pad, pad_eval
from scl_deepfake_audio_detection_torch.utils.audio_io import load_audio
from scl_deepfake_audio_detection_torch.utils.config import RawBoostConfig
from scl_deepfake_audio_detection_torch.utils.registry import AUGMENTATIONS, DATASETS


@dataclass
class SCLBatchSpec:
    """Dataset kwargs, in the schema of ``config['data']['kwargs']``."""

    variant: str = "augall_3"
    vocoders: Sequence[str] = ()
    augmentation_methods: Sequence[str] = ("RawBoost12",)
    num_additional_real: int = 2
    num_additional_spoof: int = 2
    trim_length: int = 64000
    wav_samp_rate: int = 16000
    repeat_pad: bool = True

    def __post_init__(self):
        if not self.augmentation_methods:
            self.augmentation_methods = ("RawBoost12",)

    @property
    def num_views(self) -> int:
        m = len(self.augmentation_methods)
        v = len(self.vocoders)
        r = self.num_additional_real
        s = self.num_additional_spoof
        if self.variant == "augall_3":
            return 1 + m + r + 2 * v
        if self.variant == "aug_2":
            return 1 + m + 2 * r + 2 * v
        if self.variant == "augall_5":
            return 1 + m + r + 2 * v + s
        if self.variant == "scl_normal":
            return 1 + m + 2 * r + 2 * s
        if self.variant == "xinwang":
            return 1 + m + v * (1 + m)
        raise ValueError(f"unknown variant {self.variant!r}")


def _sample_distinct(rng: np.random.Generator, n: int, k: int,
                     exclude: Optional[int] = None) -> np.ndarray:
    """k distinct picks from range(n) without ``exclude`` (the reference's
    ``idxs.remove(idx)`` then ``np.random.choice(idxs, k, replace=False)``);
    with replacement only when the pool is smaller than k, so V stays
    fixed."""
    if n <= 0:
        raise ValueError(
            "cannot sample from an empty pool — no files found for this "
            "role (e.g. num_additional_spoof > 0 with an empty spoof dir)")
    pool = np.arange(n)
    if exclude is not None:
        pool = pool[pool != exclude]
    if len(pool) >= k:
        return rng.choice(pool, k, replace=False)
    if len(pool) == 0:  # a single-file list: reuse the anchor
        pool = np.arange(n)
    return rng.choice(pool, k, replace=True)


class SCLViewBatchBuilder:
    """Builds (utt_id, wav [V, trim_length], labels [V]) anchor groups."""

    def __init__(self, spec: SCLBatchSpec, base_dir: str, file_list: Sequence[str],
                 resources: Optional[AugmentResources] = None, seed: int = 1234):
        self.spec = spec
        self.base_dir = base_dir
        self.bonafide_dir = os.path.join(base_dir, "bonafide")
        self.vocoded_dir = os.path.join(base_dir, "vocoded")
        self.spoof_dirs = self._find_spoof_dirs(base_dir, spec.variant)
        self.files = list(file_list)
        self.res = resources or AugmentResources()
        self.seed = seed
        self._spoof_list: Optional[List[Tuple[str, str]]] = None

    @staticmethod
    def _find_spoof_dirs(base_dir: str, variant: str) -> List[str]:
        if variant == "scl_normal":  # SCL_normal.py:79-83: spoof_train/spoof_dev
            dirs = [d for d in (os.path.join(base_dir, "spoof_train"),
                                os.path.join(base_dir, "spoof_dev")) if os.path.isdir(d)]
            if dirs:
                return dirs
        return [os.path.join(base_dir, "spoof")]

    @property
    def spoof_list(self) -> List[Tuple[str, str]]:
        if self._spoof_list is None:
            out = []
            for d in self.spoof_dirs:
                if os.path.isdir(d):
                    out += [(d, f) for f in sorted(os.listdir(d))
                            if f.endswith((".wav", ".flac"))]
            self._spoof_list = out
        return self._spoof_list

    def __len__(self) -> int:
        return len(self.files)

    def _rng(self, idx: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, epoch, idx]))

    def _load(self, path: str) -> np.ndarray:
        return load_audio(path, self.spec.wav_samp_rate)

    def _augment(self, method: str, wav: np.ndarray, rng, utt_path: str) -> np.ndarray:
        # the full path: the offline cache keys by basename and needs the
        # path to catch two sources with one basename
        fn = AUGMENTATIONS.get(method)
        return np.asarray(fn(wav, rng, self.res, utt_id=utt_path), np.float32)

    def build(self, idx: int, epoch: int = 0) -> Tuple[str, np.ndarray, np.ndarray]:
        spec = self.spec
        rng = self._rng(idx, epoch)
        utt = self.files[idx]
        anchor_path = os.path.join(self.bonafide_dir, utt)
        anchor = self._load(anchor_path)
        methods = list(spec.augmentation_methods)

        def aug_all(wav, path):  # one view per configured method
            return [self._augment(m, wav, rng, path) for m in methods]

        def aug_rand(wav, path):  # one view, a random method (aug_2, scl_normal)
            m = methods[int(rng.integers(len(methods)))]
            return self._augment(m, wav, rng, path)

        def load_vocoded():
            voc, voc_aug = [], []
            for v in spec.vocoders:
                p = os.path.join(self.vocoded_dir, f"{v}_{utt}")
                w = self._load(p)
                voc.append(w)
                if spec.variant == "aug_2":
                    voc_aug.append(aug_rand(w, p))
                elif spec.variant == "xinwang":
                    voc_aug += aug_all(w, p)
                else:  # augall_3, augall_5: the first method only
                    voc_aug.append(self._augment(methods[0], w, rng, p))
            return voc, voc_aug

        def load_additional_reals():
            picks = _sample_distinct(rng, len(self.files), spec.num_additional_real,
                                     exclude=idx)
            paths = [os.path.join(self.bonafide_dir, self.files[i]) for i in picks]
            return [(self._load(p), p) for p in paths]

        def load_additional_spoofs():
            pool = self.spoof_list
            picks = _sample_distinct(rng, len(pool), spec.num_additional_spoof)
            paths = [os.path.join(pool[i][0], pool[i][1]) for i in picks]
            return [(self._load(p), p) for p in paths]

        pos: List[np.ndarray] = [anchor] + aug_all(anchor, anchor_path)
        neg: List[np.ndarray] = []
        if spec.variant in ("augall_3", "augall_5"):
            pos += [w for w, _ in load_additional_reals()]
            voc, voc_aug = load_vocoded()
            neg += voc + voc_aug
            if spec.variant == "augall_5":
                neg += [w for w, _ in load_additional_spoofs()]
        elif spec.variant == "aug_2":
            reals = load_additional_reals()
            pos += [w for w, _ in reals]
            pos += [aug_rand(w, p) for w, p in reals]
            voc, voc_aug = load_vocoded()
            neg += voc + voc_aug
        elif spec.variant == "scl_normal":
            reals = load_additional_reals()
            pos += [w for w, _ in reals]
            pos += [aug_rand(w, p) for w, p in reals]
            spoofs = load_additional_spoofs()
            neg += [w for w, _ in spoofs]
            neg += [aug_rand(w, p) for w, p in spoofs]
        elif spec.variant == "xinwang":
            voc, voc_aug = load_vocoded()
            neg += voc + voc_aug
        else:
            raise ValueError(f"unknown variant {spec.variant!r}")

        views = pos + neg
        batch = multiview_pad(views, spec.trim_length, repeat_pad=spec.repeat_pad,
                              random_trim=True, rng=rng).astype(np.float32)
        labels = np.concatenate([np.ones(len(pos), np.float32),
                                 np.zeros(len(neg), np.float32)])
        assert batch.shape[0] == spec.num_views, (batch.shape, spec.num_views)
        return utt, batch, labels

    def build_raw(self, idx: int, epoch: int = 0) -> Dict:
        """Decode and co-crop only, for the on-device composer
        (``data/device_pipeline``): {'utt', 'anchor' [T], 'reals' [n_real,
        T], 'vocoded' [n_voc, T], 'spoofs' [n_spoof, T]}.  Only the roles
        the variant's recipe consumes are loaded, as ``build`` gates them:
        the composer concatenates whatever arrives, so spoofs decoded for
        augall_3 would train augall_5's recipe."""
        spec = self.spec
        rng = self._rng(idx, epoch)
        utt = self.files[idx]
        anchor = self._load(os.path.join(self.bonafide_dir, utt))
        uses_reals = spec.variant != "xinwang"
        uses_spoofs = spec.variant in ("augall_5", "scl_normal")
        reals = [
            self._load(os.path.join(self.bonafide_dir, self.files[i]))
            for i in _sample_distinct(rng, len(self.files), spec.num_additional_real,
                                      exclude=idx)
        ] if (uses_reals and spec.num_additional_real) else []
        voc = ([self._load(os.path.join(self.vocoded_dir, f"{v}_{utt}"))
                for v in spec.vocoders] if spec.variant != "scl_normal" else [])
        spoofs = []
        if uses_spoofs and spec.num_additional_spoof:
            picks = _sample_distinct(rng, len(self.spoof_list), spec.num_additional_spoof)
            spoofs = [self._load(os.path.join(*self.spoof_list[i])) for i in picks]
        stack = multiview_pad([anchor] + reals + voc + spoofs, spec.trim_length,
                              repeat_pad=spec.repeat_pad, random_trim=True,
                              rng=rng).astype(np.float32)
        nr, nv = len(reals), len(voc)
        return {"utt": utt, "anchor": stack[0], "reals": stack[1:1 + nr],
                "vocoded": stack[1 + nr:1 + nr + nv], "spoofs": stack[1 + nr + nv:]}


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
        # a data.decode_cache.DecodeCache (warm_decode_cache attaches one):
        # its utterances are read as memmap slices instead of decoded
        self.decode_cache = None

    def __len__(self) -> int:
        return len(self.files)

    def get(self, idx: int) -> Tuple[np.ndarray, str]:
        wav, utt = self.get_raw(idx)
        return pad_eval(wav, self.padding_type, self.cut).astype(np.float32), utt

    def get_raw(self, idx: int) -> Tuple[np.ndarray, str]:
        """Full-length audio, neither padded nor cut (``--long_audio``)."""
        utt = self.files[idx]
        if self.decode_cache is not None and self.decode_cache.has(utt):
            return self.decode_cache.get(utt), utt
        return load_audio(os.path.join(self.base_dir, utt), self.sample_rate), utt

    def warm_decode_cache(self, cache_dir: str, num_workers: int = 4):
        """Build (or open) the packed decode cache of this dataset's files
        and attach it."""
        from scl_deepfake_audio_detection_torch.data.decode_cache import DecodeCache

        cache = DecodeCache(cache_dir)
        reusable = cache.ready and cache.sample_rate == self.sample_rate
        if not reusable or not all(cache.has(u) for u in self.files):
            old = cache if reusable else None

            def load(u):
                # an incremental rebuild reads the old cache's hits instead
                # of decoding the whole list again for one new file
                if old is not None and old.has(u):
                    return old.get(u)
                return load_audio(os.path.join(self.base_dir, u), self.sample_rate)

            cache = DecodeCache.build(cache_dir, self.files, load,
                                      sample_rate=self.sample_rate, num_workers=num_workers)
        self.decode_cache = cache
        return cache


# reference dataset-module names -> descriptors
_VARIANTS: Dict[str, Dict] = {
    "asvspoof_2019_augall_3": {"variant": "augall_3", "eval_subdir": True},
    "asvspoof_2019_aug_2": {"variant": "aug_2", "eval_subdir": True},
    "asvspoof_2019_augall_5": {"variant": "augall_5", "eval_subdir": True},
    "SCL_normal": {"variant": "scl_normal", "eval_subdir": True},
    "asvspoof_2019_xinwang": {"variant": "xinwang", "eval_subdir": True, "repeat_pad": False},
    "eval_only": {"variant": None, "eval_subdir": False},
}

for _name, _desc in _VARIANTS.items():
    DATASETS.register(_name)(dict(_desc))


def spec_from_config(name: str, kwargs: Dict) -> Optional[SCLBatchSpec]:
    """DataConfig (name, kwargs) -> SCLBatchSpec; None for eval_only."""
    desc = DATASETS.get(name)
    if desc["variant"] is None:
        return None
    known = {"vocoders", "augmentation_methods", "num_additional_real",
             "num_additional_spoof", "trim_length", "wav_samp_rate"}
    clean = {k: v for k, v in kwargs.items() if k in known}
    return SCLBatchSpec(variant=desc["variant"], repeat_pad=desc.get("repeat_pad", True),
                        **clean)


def resources_from_config(kwargs: Dict, rawboost: Optional[RawBoostConfig] = None
                          ) -> AugmentResources:
    return AugmentResources(
        rawboost=rawboost or RawBoostConfig(),
        sample_rate=int(kwargs.get("wav_samp_rate", 16000)),
        noise_path=kwargs.get("noise_path"),
        rir_path=kwargs.get("rir_path"),
        aug_dir=kwargs.get("aug_dir"),
        online=bool(kwargs.get("online_aug", True)),
    )
