"""Generic GAN trainer — capability match for the vendored NII GAN manager.

Counterpart of ``scl_deepfake_audio_detection_tpu/train/gan.py``.  The
reference carries ``core_scripts/nn_manager/nn_manager_GAN.py`` (dead on its
active path) whose capability is one training loop driving a
generator/discriminator pair with separate optimizers, alternating D-then-G
updates per batch (``f_run_one_epoch_GAN`` ``:33-174``), with per-epoch
checkpoints.  Its sibling ``nn_manager_GAN_ob.py`` adds the
observed-condition flavor — G consumes conditioning input, an auxiliary
reconstruction loss ``compute_aux(data_gen, data_tar)`` joins the GAN term
(``:306-309``) — and a WGAN epoch (``f_run_one_epoch_WGAN:206-349``: critic
weight clamp 0.01, generator update every ``num_critic=5`` batches); both
are covered here via ``mode='wgan'`` / ``aux_loss_fn`` / dict batches.

One step updates D first, on the real batch against a detached fake, then G
through the updated D, as the JAX step does; each of the step's five
forwards draws its dropout from a fresh ``torch.Generator`` seeded from
(``seed``, epoch, step, forward), as the JAX step splits one key five ways.

The nets are ``nn.Module``s on one device, each with an ``apply(x,
train=..., generator=...)`` like the port's models: the generator maps
latents ``[N, z_dim]`` to the fake batch, the discriminator returns logits
``[N]`` (or ``[N, 1]``).  Each has its own ``train/optim.Optimizer``
(AdamW, the JAX package's ``make_optimizer(weight_decay)``).  ``mesh``:
None is one device; a ``DeviceMesh`` splits each batch over 'data' (the
latents drawn whole first) and the optimizers average both nets' gradients
over 'data', as ``Engine`` does.  ``gan_last.ckpt`` holds both nets in the
JAX tree layout and both optimizer states as optax's leaves
(``opt_g_leaves``, ``opt_d_leaves``), so each package loads the other's.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from scl_deepfake_audio_detection_torch.models.params import load_jax_params, to_jax
from scl_deepfake_audio_detection_torch.parallel.mesh import MeshContext, batch_shard
from scl_deepfake_audio_detection_torch.train import checkpoint as ckpt
from scl_deepfake_audio_detection_torch.train.engine import MetricMean
from scl_deepfake_audio_detection_torch.train.optim import make_optimizer, set_learning_rate


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Numerically-stable sigmoid BCE against a constant 0/1 target."""
    logits = logits.reshape(-1).float()
    # log(sigmoid(x)) = -softplus(-x); log(1-sigmoid(x)) = -softplus(x)
    return torch.mean(F.softplus(-logits) if target == 1.0 else F.softplus(logits))


def d_loss_nonsaturating(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    return bce_logits(d_real, 1.0) + bce_logits(d_fake, 0.0)


def g_loss_nonsaturating(d_fake: torch.Tensor) -> torch.Tensor:
    return bce_logits(d_fake, 1.0)


def d_loss_wasserstein(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """Critic loss for WGAN (``nn_manager_GAN_ob.py:255-296`` splits this into
    compute_gan_D_real/_fake; the sum is E[D(fake)] - E[D(real)])."""
    return torch.mean(d_fake.float()) - torch.mean(d_real.float())


def g_loss_wasserstein(d_fake: torch.Tensor) -> torch.Tensor:
    return -torch.mean(d_fake.float())


def mse_aux(fake: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Default auxiliary reconstruction loss for the conditional flavor
    (``compute_aux(data_gen, data_tar)``, ``nn_manager_GAN_ob.py:306-309``)."""
    return torch.mean((fake.float() - target.float()) ** 2)


def _generators(seed: int, epoch: int, step: int, n: int, device) -> list:
    """``n`` independent generators of one step's draws on ``device``."""
    states = np.random.SeedSequence([seed, epoch, step]).generate_state(n, np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in states]


class GANEngine:
    """Owns both nets' optimizers, the alternating step and the
    epoch/checkpoint loop."""

    def __init__(
        self,
        generator,
        discriminator,
        z_dim: int,
        lr_g: float = 1e-4,
        lr_d: float = 1e-4,
        weight_decay: float = 0.0,
        d_loss_fn: Optional[Callable] = None,
        g_loss_fn: Optional[Callable] = None,
        mode: str = "gan",
        n_critic: Optional[int] = None,
        weight_clip: Optional[float] = None,
        aux_loss_fn: Optional[Callable] = None,
        mesh=None,
        seed: int = 0,
    ):
        """``mode='wgan'`` selects the Wasserstein flavor of the NII
        ``nn_manager_GAN_ob`` manager (``f_run_one_epoch_WGAN:206-349``):
        critic losses, weight clamp (default 0.01) and a generator update
        every ``n_critic`` (default 5) steps. ``aux_loss_fn(fake, target)``
        adds the conditional manager's reconstruction term (``compute_aux``)
        — pass conditioning features as the ``z`` stream (dict batches with
        a ``"z"`` key) and targets as ``real``.  ``seed`` keys every draw
        (dropout, latents)."""
        if mode not in ("gan", "wgan"):
            raise ValueError(f"unknown GAN mode {mode!r}")
        if mode == "wgan":
            d_loss_fn = d_loss_fn or d_loss_wasserstein
            g_loss_fn = g_loss_fn or g_loss_wasserstein
            n_critic = 5 if n_critic is None else n_critic
            weight_clip = 0.01 if weight_clip is None else weight_clip
        else:
            d_loss_fn = d_loss_fn or d_loss_nonsaturating
            g_loss_fn = g_loss_fn or g_loss_nonsaturating
            n_critic = 1 if n_critic is None else n_critic
        self.gen, self.disc, self.z_dim = generator, discriminator, z_dim
        self.d_loss_fn, self.g_loss_fn, self.aux_loss_fn = d_loss_fn, g_loss_fn, aux_loss_fn
        self.weight_clip, self.g_every = weight_clip, int(n_critic)
        self.weight_decay, self.lr_g, self.lr_d = weight_decay, lr_g, lr_d
        self.device = next(generator.parameters()).device
        self.par = MeshContext.from_mesh(mesh)
        self.seed = seed
        self.global_step = 0
        self.opt_g = self.opt_d = None

    def init_state(self, params_g=None, params_d=None):
        """Optionally load JAX parameter trees (numpy leaves) into the nets;
        make both optimizers at their learning rates.  Returns (generator,
        discriminator, opt_g, opt_d)."""
        if params_g is not None:
            load_jax_params(self.gen, params_g)
        if params_d is not None:
            load_jax_params(self.disc, params_d)
        self.opt_g = set_learning_rate(make_optimizer(
            self.gen.named_parameters(), self.weight_decay, mesh=self.par), self.lr_g)
        self.opt_d = set_learning_rate(make_optimizer(
            self.disc.named_parameters(), self.weight_decay, mesh=self.par), self.lr_d)
        return self.gen, self.disc, self.opt_g, self.opt_d

    def step(self, real, z, step_idx: int, generators) -> Dict[str, torch.Tensor]:
        """One alternating update on placed ``real`` and ``z``; the five
        forwards (G, D on real, D on fake, G again, D on G's output) draw from
        ``generators`` in that order.  Returns the metrics as device scalars."""
        g_g, g_dr, g_df, g_g2, g_dg = generators
        pd = [p for p in self.disc.parameters() if p.requires_grad]
        pg = [p for p in self.gen.parameters() if p.requires_grad]

        # --- discriminator update: real up, (detached) fake down -----------
        with torch.no_grad():
            fake = self.gen.apply(z, train=True, generator=g_g)
        d_val = self.d_loss_fn(self.disc.apply(real, train=True, generator=g_dr),
                               self.disc.apply(fake, train=True, generator=g_df))
        for p, g in zip(pd, torch.autograd.grad(d_val, pd)):
            p.grad = g
        self.opt_d.step()
        if self.weight_clip is not None:
            # WGAN critic 1-Lipschitz enforcement by clamping
            # (nn_manager_GAN_ob.py:299-301)
            c = float(self.weight_clip)
            with torch.no_grad():
                for p in pd:
                    p.clamp_(-c, c)

        # --- generator update through the UPDATED discriminator ------------
        def g_objective():
            f = self.gen.apply(z, train=True, generator=g_g2)
            gan_term = self.g_loss_fn(self.disc.apply(f, train=True, generator=g_dg))
            aux_term = (self.aux_loss_fn(f, real) if self.aux_loss_fn is not None
                        else torch.zeros((), device=gan_term.device))
            return gan_term, aux_term

        if step_idx % self.g_every == 0:
            g_val, aux_val = g_objective()
            for p, g in zip(pg, torch.autograd.grad(g_val + aux_val, pg)):
                p.grad = g
            self.opt_g.step()
        else:
            # WGAN: the generator moves only every `g_every` critic steps
            # (num_critic, nn_manager_GAN_ob.py:222,312-315); the objective is
            # still evaluated (the reference logs errG every batch), with no
            # backward
            with torch.no_grad():
                g_val, aux_val = g_objective()
        return self.par.mean_metrics({"d_loss": d_val.detach(), "g_loss": g_val.detach(),
                                      "g_aux": aux_val.detach()})

    def _place(self, batch, gens):
        if isinstance(batch, dict):
            # conditional flavor: caller provides the generator input
            # ("z" = conditioning features) and the target ("real")
            real, z = torch.as_tensor(batch["real"]), torch.as_tensor(batch["z"])
            real, z = real.to(self.device), z.to(self.device)
        else:
            real = torch.as_tensor(batch).to(self.device)
            z = torch.randn((real.shape[0], self.z_dim), generator=gens[5],
                            device=self.device)
        local, shard = self.par.shard_batch({"real": real, "z": z})
        return local["real"], local["z"], shard

    def run_epoch(self, real_batches: Iterable, epoch: int = 0) -> Dict[str, float]:
        """One epoch over ``real_batches`` (arrays, or dicts with ``real`` and
        ``z``); the metric means come back to the host once, at the end."""
        if self.opt_g is None:
            self.init_state()
        agg = MetricMean()
        for i, batch in enumerate(real_batches):
            gens = _generators(self.seed, epoch, i, 6, self.device)
            real, z, shard = self._place(batch, gens)
            with batch_shard(shard):
                agg.add(self.step(real, z, self.global_step, gens[:5]))
            self.global_step += 1
        return agg.result()

    def save(self, path: str, epoch: int) -> None:
        """Both nets + both optimizer states in the JAX package's layout,
        resumable like the NII manager's joint checkpoint
        (``nn_manager_GAN.py:214-218``); rank 0 writes."""
        tree = {"params_g": to_jax(self.gen), "params_d": to_jax(self.disc),
                "opt_g_leaves": ckpt.pack_opt_leaves(self.gen, self.opt_g),
                "opt_d_leaves": ckpt.pack_opt_leaves(self.disc, self.opt_d)}
        if self.par.is_writer:
            ckpt.save(path, tree, extra={"epoch": int(epoch)})

    def load(self, path: str) -> Dict:
        """Load a GAN checkpoint of either package into both nets and both
        optimizers; returns its ``extra``."""
        if self.opt_g is None:
            self.init_state()
        tree, extra = ckpt.load(path)
        load_jax_params(self.gen, tree["params_g"])
        load_jax_params(self.disc, tree["params_d"])
        ckpt.unpack_opt_leaves(tree["opt_g_leaves"], self.gen, self.opt_g)
        ckpt.unpack_opt_leaves(tree["opt_d_leaves"], self.disc, self.opt_d)
        return extra

    def fit(self, real_batches_fn: Callable[[], Iterable], num_epochs: int,
            save_dir: Optional[str] = None,
            log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None
            ) -> Tuple:
        """``num_epochs`` epochs, ``gan_last.ckpt`` under ``save_dir`` after
        each; returns (generator, discriminator, opt_g, opt_d)."""
        if self.opt_g is None:
            self.init_state()
        for epoch in range(num_epochs):
            metrics = self.run_epoch(real_batches_fn(), epoch)
            if log_fn:
                log_fn(epoch, metrics)
            if save_dir:
                self.save(f"{save_dir}/gan_last.ckpt", epoch)
        return self.gen, self.disc, self.opt_g, self.opt_d
