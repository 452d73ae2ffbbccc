"""Process groups, the ('data', 'model') mesh and its sharding rules.

Counterpart of ``scl_deepfake_audio_detection_tpu/parallel/mesh.py``.  The
JAX package runs one process per host and lets XLA partition one program
over a ``Mesh``; the port runs one process (a rank) per card, as torch
does, over ``torch.distributed``, and keeps the JAX package's semantics:

- **data**: the anchor groups of a step are split over the data ranks; each
  computes its groups' loss, and the gradients are averaged over 'data'
  before clipping and the update, so ``--mesh D,M`` trains the trajectory
  of ``--mesh 1,1`` on the same batches;
- **model**: tensor parallelism inside the XLS-R encoder, the heads and the
  FFN hidden units split over the model ranks: q, k, v and fc1 are
  column-parallel, o and fc2 row-parallel, each followed by one all-reduce
  over 'model' (``models/xlsr.EncoderLayer``);
- **ZeRO-1**: the AdamW moments of the larger leaves are split over 'data'
  on an axis 'model' leaves free (``zero1_spec``; ``train/optim``).

Rank r sits at (r // M, r % M): data outer, model inner, as the JAX mesh
lays its devices.  ``make_mesh`` returns a ``DeviceMesh`` with those two
named dims; ``MeshContext`` holds this rank's place in it and the
collectives the step runs.  The collectives that sit on the autograd path
(``copy_to_model``, ``reduce_from_model``, ``all_reduce_sum``,
``gather_rows``) have explicit backward rules.

The backend is NCCL for CUDA tensors and gloo for the CPU.
``SCL_DIST_BACKEND=gloo`` chooses gloo for CUDA tensors too, which lets
several ranks share one card (NCCL refuses that); gloo collectives on CUDA
tensors are staged through host memory here.

Bootstrap (``launch``, ``join_environment``): under torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
a process joins that group; with none, ``launch`` starts the ranks itself
(``torch.multiprocessing`` spawn, one per local card, a ``file://``
rendezvous in a temporary directory).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import re
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
ZERO1_MIN_SIZE = 1 << 16  # below this many elements a leaf's moments stay whole
_ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


# ------------------------------------------------------------- process groups

def backend_for(device_type: str) -> str:
    """The backend of a process group whose tensors live on ``device_type``:
    ``SCL_DIST_BACKEND`` when set, else NCCL for CUDA and gloo for the CPU."""
    return os.environ.get("SCL_DIST_BACKEND") or ("nccl" if device_type == "cuda" else "gloo")


def cluster_env() -> Optional[Dict[str, Any]]:
    """The process's place in an explicit cluster (torchrun's variables, or
    ``launch``'s, which adds a ``SCL_DIST_INIT`` rendezvous URL), or None
    when no variable of it is set.  A set that is incomplete or out of range
    raises ``ValueError``: a cluster that was asked for must not quietly run
    as one process."""
    present = [k for k in _ENV_KEYS if os.environ.get(k)]
    if not present:
        return None
    init = os.environ.get("SCL_DIST_INIT")
    need = ("RANK", "WORLD_SIZE") + (() if init else ("MASTER_ADDR", "MASTER_PORT"))
    missing = [k for k in need if not os.environ.get(k)]
    if missing:
        raise ValueError(f"distributed environment incomplete: {', '.join(missing)} unset "
                         f"({', '.join(present)} set)")
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        if not init:
            int(os.environ["MASTER_PORT"])
    except ValueError as e:
        raise ValueError(f"distributed environment malformed: {e}") from None
    if world < 1 or not 0 <= rank < world or local < 0:
        raise ValueError(f"distributed environment malformed: RANK={rank} "
                         f"WORLD_SIZE={world} LOCAL_RANK={local}")
    return {"rank": rank, "world": world, "local_rank": local,
            "local_world": int(os.environ.get("LOCAL_WORLD_SIZE", world)),
            "init_method": init or "env://"}


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """This rank's device: the CPU, or the card ``local_rank`` (modulo the
    cards present when gloo shares them)."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))


def check_cards(ranks: int, device_type: str) -> None:
    """NCCL puts one rank on a card: fewer cards than local ranks raises
    ``ValueError`` naming both numbers."""
    if device_type != "cuda" or backend_for("cuda") != "nccl":
        return
    cards = torch.cuda.device_count()
    if cards < ranks:
        raise ValueError(f"{ranks} ranks need {ranks} cards (one rank a card over NCCL); "
                         f"this host has {cards}")


def init_process_group(device_type: str, rank: int = 0, world: int = 1,
                       init_method: Optional[str] = None, local_rank: int = 0) -> torch.device:
    """Join (or form) the default process group; returns this rank's device.
    Without ``init_method`` a group of one forms in this process."""
    device = rank_device(device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {"init_method": init_method} if init_method else {"store": dist.HashStore()}
        dist.init_process_group(backend_for(device_type), rank=rank, world_size=world, **kw)
    return device


def join_environment(device_type: str, world: Optional[int] = None) -> Optional[torch.device]:
    """Join the group the environment describes (``cluster_env``) and
    return this rank's device; None when the environment describes none.
    ``world`` (the mesh's size) must equal ``WORLD_SIZE`` when given."""
    env = cluster_env()
    if env is None:
        return None
    if world is not None and world != env["world"]:
        raise ValueError(f"mesh of {world} ranks != WORLD_SIZE {env['world']}")
    check_cards(env["local_world"], device_type)
    return init_process_group(device_type, env["rank"], env["world"], env["init_method"],
                              env["local_rank"])


def leave() -> None:
    """Leave the default process group (a barrier first, so that no rank
    tears it down while another still reads from it)."""
    if is_distributed():
        dist.barrier()
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def _rank_entry(target, r: int, world: int, init: str, args, threads: int) -> None:
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                      LOCAL_WORLD_SIZE=str(world), SCL_DIST_INIT=init)
    torch.set_num_threads(threads)
    try:
        rc = target(*args)
    except SystemExit as e:
        rc = e.code
    except BaseException:  # noqa: BLE001 -- the parent reads the exit code
        traceback.print_exc()
        rc = 1
    finally:
        if is_distributed():
            dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(int(rc or 0) if isinstance(rc, (int, type(None))) else 1)


def launch(target: Callable, world: int, args: Sequence = (), threads: Optional[int] = None,
           timeout: Optional[float] = None) -> List[int]:
    """Run ``target(*args)`` in ``world`` spawned ranks with a ``file://``
    rendezvous and return their exit codes (``target``'s return value, 1 on
    an exception).  ``target`` must be importable by name in a fresh
    interpreter.  When a rank fails, or ``timeout`` seconds pass, the rest
    are stopped.  Each rank takes ``threads`` torch threads (default: the
    cores over the ranks)."""
    import multiprocessing as mp

    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="scl_rdzv_") as d:
        init = f"file://{os.path.join(d, 'store')}"
        procs = [ctx.Process(target=_rank_entry, args=(target, r, world, init, tuple(args),
                                                       threads)) for r in range(world)]
        for p in procs:
            p.start()
        t0 = time.time()
        try:
            while any(p.is_alive() for p in procs):
                failed = any(p.exitcode not in (None, 0) for p in procs)
                late = timeout is not None and time.time() - t0 > timeout
                if failed or late:
                    for p in procs:
                        if p.is_alive():
                            p.terminate()
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [p.exitcode if p.exitcode is not None else 1 for p in procs]


# ------------------------------------------------------------------- the mesh

def parse_mesh(text) -> Optional[Tuple[int, int]]:
    """'D,M' (or a sequence) -> (D, M); None stays None."""
    if text is None:
        return None
    vals = [int(v) for v in (text.split(",") if isinstance(text, str) else text)]
    if len(vals) != 2 or min(vals) < 1:
        raise ValueError(f"mesh shape must be two positive sizes 'data,model', got {text!r}")
    return vals[0], vals[1]


def make_mesh(shape: Optional[Sequence[int]] = None, device_type: Optional[str] = None):
    """A ``DeviceMesh`` with dims ('data', 'model') over the default group's
    ranks; the default puts every rank on 'data'.  A shape whose product is
    not the world size raises ``ValueError``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def _staged(group) -> bool:
    """gloo collectives on CUDA tensors go through host memory."""
    return dist.get_backend(group) == "gloo"


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    if t.is_cuda and _staged(group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    src = t.contiguous()
    if src.is_cuda and _staged(group):
        parts = [torch.empty_like(src, device="cpu") for _ in range(size)]
        dist.all_gather(parts, src.cpu(), group=group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return parts


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward; the backward sums the gradient
    too: every rank's output depends on every rank's input (batch-norm
    moments).  With ``identity_bwd`` the backward passes the gradient
    through (the output of a row-parallel product, whose gradient is
    already the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group, identity_bwd):
        ctx.group, ctx.identity_bwd = group, identity_bwd
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        if ctx.identity_bwd:
            return g, None, None
        return _all_reduce_(g.clone(), ctx.group), None, None


class _GatherRows(torch.autograd.Function):
    """Concatenate every rank's rows; the backward keeps this rank's rows of
    the gradient times the group size.  For a loss every rank computes
    alike from the gathered rows: the data-parallel mean of the gradients
    then sums the ranks' shares."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.size, ctx.index, ctx.n = size, index, x.shape[0]
        return torch.cat(_all_gather(x, group, size))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.n, ctx.n) * ctx.size, None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group, True)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (every rank's output depends on
    every rank's input)."""
    return _AllReduceSum.apply(x, group, False)


# ----------------------------------------------------- data-parallel batches

@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rows [start, stop) of a data-parallel step's ``total`` rows (views);
    ``group`` spans the data ranks that share the step."""

    group: Any
    size: int
    index: int
    start: int
    stop: int
    total: int


_BATCH_SHARD: Optional[BatchShard] = None


def current_shard() -> Optional[BatchShard]:
    """The shard of the step being computed (set by ``batch_shard``), read
    by ``ops/layers.dropout`` and ``ops/layers.batch_norm``."""
    return _BATCH_SHARD


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Within the block, dropout draws the masks of the whole step's rows
    and keeps this shard's, and training batch norm takes its moments over
    every shard.  A module global (not thread-local): the autograd thread
    recomputes remat blocks under it."""
    global _BATCH_SHARD
    prev, _BATCH_SHARD = _BATCH_SHARD, shard
    try:
        yield
    finally:
        _BATCH_SHARD = prev


# --------------------------------------------------------------- parameters

# (port parameter name of an XLS-R encoder layer, the dim split over
# 'model'): torch layout [out, in], so column-parallel weights split dim 0
# and row-parallel ones dim 1 (the JAX rules, ``:53-64``, on [in, out]).
_RULES = (
    (re.compile(r"attn\.(q|k|v)\.(weight|bias)$"), 0),
    (re.compile(r"attn\.o\.weight$"), 1),
    (re.compile(r"fc1\.(weight|bias)$"), 0),
    (re.compile(r"fc2\.weight$"), 1),
)


def param_pspecs(model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """Every parameter name of ``model`` -> the dim split over 'model', or
    None (replicated).  The rules match the parameters of XLS-R encoder
    layers (``models/xlsr.EncoderLayer``) only; ``fuse_qkv``'s [3D, D]
    product is the concatenation of the split q, k and v, so it splits per
    head with them."""
    from scl_deepfake_audio_detection_torch.models.xlsr import EncoderLayer

    specs = {n: None for n, _ in model.named_parameters()}
    for prefix, m in model.named_modules():
        if not isinstance(m, EncoderLayer):
            continue
        for attr, _ in m.named_parameters():
            for pat, dim in _RULES:
                if pat.search(attr):
                    specs[f"{prefix}.{attr}" if prefix else attr] = dim
    return specs


def _narrow(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    n = t.shape[dim] // count
    return t.narrow(dim, index * n, n)


class TensorParallel:
    """A model's tensor-parallel layout: which parameters are split on which
    dim over the model group.  ``models/params`` reads it (as the model's
    ``tensor_parallel`` attribute) to load full tensors into shards and to
    gather them for a save."""

    def __init__(self, dims: Dict[str, int], group, size: int, index: int):
        self.dims, self.group, self.size, self.index = dims, group, size, index

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        dim = self.dims.get(name)
        return full if dim is None else _narrow(full, dim, self.index, self.size)

    def full_shape(self, name: str, shape) -> Tuple[int, ...]:
        shape = list(shape)
        dim = self.dims.get(name)
        if dim is not None:
            shape[dim] *= self.size
        return tuple(shape)

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor (a collective over the model group)."""
        dim = self.dims.get(name)
        if dim is None:
            return local
        return torch.cat(_all_gather(local.detach(), self.group, self.size), dim=dim)


def shard_params(model: torch.nn.Module, mesh_ctx: "MeshContext") -> torch.nn.Module:
    """Replace each tensor-parallel parameter of ``model`` by this rank's
    shard (in place; the full tensors are dropped) and tell the encoder
    layers their model group.  A model axis of 1 changes nothing.  Raises
    ``ValueError`` when the model axis does not divide the heads or the FFN
    width."""
    from scl_deepfake_audio_detection_torch.models.xlsr import EncoderLayer

    m_size = mesh_ctx.tp
    if m_size == 1 or getattr(model, "tensor_parallel", None) is not None:
        return model
    for m in model.modules():
        if isinstance(m, EncoderLayer):
            cfg = m.cfg
            if cfg.num_heads % m_size or cfg.ffn_dim % m_size:
                raise ValueError(f"model axis {m_size} must divide num_heads "
                                 f"{cfg.num_heads} and ffn_dim {cfg.ffn_dim}")
    dims = {n: d for n, d in param_pspecs(model).items() if d is not None}
    tp = TensorParallel(dims, mesh_ctx.model_group, m_size, mesh_ctx.model_rank)
    with torch.no_grad():
        for name in dims:
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            p = getattr(mod, attr)
            p.data = tp.local(name, p.data).clone()
    for m in model.modules():
        if isinstance(m, EncoderLayer):
            m.tp = (mesh_ctx.model_group, m_size, mesh_ctx.model_rank)
    model.tensor_parallel = tp
    return model


def gather_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """name -> the whole parameter (a collective over the model group when
    ``model`` is split)."""
    tp = getattr(model, "tensor_parallel", None)
    return {n: (p.detach() if tp is None else tp.full(n, p))
            for n, p in model.named_parameters()}


def zero1_spec(shape: Sequence[int], data_size: int, taken: Optional[int] = None,
               min_size: int = ZERO1_MIN_SIZE, full_size: Optional[int] = None) -> Optional[int]:
    """The axis of a leaf of ``shape`` whose moments ZeRO-1 splits over
    'data', or None (kept whole): the largest axis that divides by the data
    size and is not ``taken`` (the axis split over 'model'), for leaves of
    at least ``min_size`` elements (``full_size``, the unsplit count, when
    the leaf is a tensor-parallel shard)."""
    size = full_size if full_size is not None else math.prod(shape)
    if data_size == 1 or not shape or size < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i != taken and shape[i] % data_size == 0:
            return i
    return None


@dataclasses.dataclass
class MeshContext:
    """This rank's place in the mesh, and the collectives of a step over it.
    ``MeshContext()`` is one process: every operation is the identity."""

    mesh: Any = None
    dp: int = 1
    tp: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    local_batches: bool = False  # --multihost: each rank's loader yields its own groups

    @classmethod
    def from_mesh(cls, mesh, local_batches: bool = False) -> "MeshContext":
        if mesh is None:
            return cls(local_batches=local_batches)
        return cls(mesh=mesh, dp=mesh.size(0), tp=mesh.size(1),
                   data_rank=mesh.get_local_rank("data"),
                   model_rank=mesh.get_local_rank("model"),
                   data_group=mesh.get_group("data"), model_group=mesh.get_group("model"),
                   local_batches=local_batches)

    @property
    def is_writer(self) -> bool:
        """Rank 0 of the whole group writes files."""
        return rank() == 0

    # ---------------------------------------------------------------- batches
    def shard(self, n: int) -> Optional[BatchShard]:
        """The shard of a step's ``n`` leading rows (this rank's if the
        loader yielded them already, else this rank's slice of them); None
        when the step is not split: one data rank, or ``n`` does not divide
        (the whole batch runs on every rank, as the JAX package replicates
        it)."""
        if self.dp == 1:
            return None
        if self.local_batches:
            return BatchShard(self.data_group, self.dp, self.data_rank,
                              self.data_rank * n, (self.data_rank + 1) * n, n * self.dp)
        if n % self.dp:
            return None
        k = n // self.dp
        return BatchShard(self.data_group, self.dp, self.data_rank,
                          self.data_rank * k, (self.data_rank + 1) * k, n)

    def shard_batch(self, batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Optional[BatchShard]]:
        """This data rank's slice of a batch of [G, ...] arrays over G and
        the shard in view rows (G*V for a [G, V, T] batch), or the batch and
        None when it is not split."""
        lead = next(v for v in batch.values() if hasattr(v, "shape"))
        g = lead.shape[0]
        per = math.prod(lead.shape[1:-1]) if len(lead.shape) > 2 else 1
        s = self.shard(g)
        if s is None:
            return batch, None
        rows = BatchShard(s.group, s.size, s.index, s.start * per, s.stop * per, s.total * per)
        if self.local_batches:
            return batch, rows
        return {k: (v[s.start:s.stop] if hasattr(v, "shape") else v)
                for k, v in batch.items()}, rows

    def gather_rows(self, x: torch.Tensor, shard: Optional[BatchShard]) -> torch.Tensor:
        """Every shard's rows of ``x`` (differentiable), or ``x`` unsplit."""
        if shard is None:
            return x
        return _GatherRows.apply(x, shard.group, shard.size, shard.index)

    # ------------------------------------------------------------- reductions
    def mean_over_data(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The data-parallel mean of each tensor, through flat buckets of
        one dtype (one all-reduce each)."""
        if self.dp == 1 or not tensors:
            return tensors
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype: Dict[Tuple[torch.dtype, torch.device], List[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault((t.dtype, t.device), []).append(i)
        for idx in by_dtype.values():
            for chunk in _buckets(idx, tensors):
                flat = torch.cat([tensors[i].reshape(-1) for i in chunk])
                _all_reduce_(flat, self.data_group).div_(self.dp)
                for i, piece in zip(chunk, flat.split([tensors[i].numel() for i in chunk])):
                    out[i] = piece.view_as(tensors[i])
        return out  # type: ignore[return-value]

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-step metrics averaged over the data ranks (each rank's are
        means over equally many rows), the same on every rank."""
        if self.dp == 1:
            return metrics
        keys = list(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        vals = _all_reduce_(vals.clone(), self.data_group) / self.dp
        return dict(zip(keys, vals.unbind()))

    def sum_over_model(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.tp == 1 else _all_reduce_(t.clone(), self.model_group)

    def gather_data(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data ranks' tensors concatenated on ``dim`` (no gradient)."""
        if self.dp == 1:
            return t
        return torch.cat(_all_gather(t.detach(), self.data_group, self.dp), dim=dim)


def _buckets(idx: List[int], tensors, cap: int = 1 << 25):
    """Runs of ``idx`` of at most ``cap`` elements (one above ``cap`` alone)."""
    run, n = [], 0
    for i in idx:
        k = tensors[i].numel()
        if run and n + k > cap:
            yield run
            run, n = [], 0
        run.append(i)
        n += k
    if run:
        yield run


def shard_batch(batch: Dict[str, Any], mesh_ctx: MeshContext) -> Dict[str, Any]:
    """This data rank's slice of a global batch over its leading axis, or
    the whole batch when the leading dim does not divide the data ranks."""
    return mesh_ctx.shard_batch(batch)[0]
