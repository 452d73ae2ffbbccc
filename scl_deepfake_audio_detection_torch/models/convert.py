"""Checkpoint converters: fairseq and HuggingFace wav2vec2 state dicts, and
the reference ``epoch_N.pth``, to and from the XLS-R parameter tree.

Counterpart of ``scl_deepfake_audio_detection_tpu/models/convert.py``.  The
importers emit the JAX parameter layout with numpy leaves: linear ``w``
[in, out], conv ``w`` [K, Cin/groups, Cout], layer norm ``scale``/``bias``
and the encoder layers stacked into [L, ...] leaves.  A model takes that
tree through ``models/params.load_jax_params``, so one map between the two
layouts serves checkpoints of either package and converted weights alike.

Layout rules handled here:

- torch Linear weights are [out, in] -> stored [in, out];
- torch Conv1d weights are [out, in, K] -> stored [K, in, out];
- the positional conv is weight-normalised in torch (dim=2); the (g, v)
  pair is contracted to a plain kernel at conversion time.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Mapping

import numpy as np
import torch

from scl_deepfake_audio_detection_torch.models.xlsr import XLSRConfig

Array = np.ndarray
StateDict = Mapping[str, Any]


def _np(t) -> Array:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _lin(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"w": _np(sd[f"{prefix}.weight"]).T.copy(), "b": _np(sd[f"{prefix}.bias"]).copy()}


def _ln(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"scale": _np(sd[f"{prefix}.weight"]).copy(),
            "bias": _np(sd[f"{prefix}.bias"]).copy()}


def _conv(sd: StateDict, prefix: str, bias: bool = True) -> Dict[str, Array]:
    p = {"w": np.transpose(_np(sd[f"{prefix}.weight"]), (2, 1, 0)).copy()}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"]).copy()
    return p


def _weight_norm_conv(g: Array, v: Array, bias) -> Dict[str, Array]:
    """Contract torch ``weight_norm(conv, dim=2)``: w = g * v / ||v||_(0,1)."""
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=(0, 1), keepdims=True))
    w = (g.astype(np.float64) * v.astype(np.float64) / norm).astype(v.dtype)
    return {"w": np.transpose(w, (2, 1, 0)).copy(), "b": _np(bias).copy()}


def config_from_fairseq(ckpt: Mapping[str, Any]) -> XLSRConfig:
    """Best-effort architecture read-out from a fairseq checkpoint dict."""
    cfg = ckpt.get("cfg") or ckpt.get("args")
    model_cfg = None
    if isinstance(cfg, Mapping):
        model_cfg = cfg.get("model", cfg)
    if model_cfg is None:
        return XLSRConfig.xlsr_300m()

    def get(name, default):
        if isinstance(model_cfg, Mapping):
            return model_cfg.get(name, default)
        return getattr(model_cfg, name, default)

    conv_spec = get("conv_feature_layers", None)
    conv_layers = XLSRConfig.xlsr_300m().conv_layers
    if isinstance(conv_spec, str):
        conv_layers = tuple(tuple(t) for t in eval(conv_spec))  # fairseq stores a literal
    return XLSRConfig(
        conv_layers=conv_layers,
        conv_bias=bool(get("conv_bias", True)),
        encoder_dim=int(get("encoder_embed_dim", 1024)),
        encoder_layers=int(get("encoder_layers", 24)),
        ffn_dim=int(get("encoder_ffn_embed_dim", 4096)),
        num_heads=int(get("encoder_attention_heads", 16)),
        pos_conv_kernel=int(get("conv_pos", 128)),
        pos_conv_groups=int(get("conv_pos_groups", 16)),
        dropout=float(get("dropout", 0.0)),
        attention_dropout=float(get("attention_dropout", 0.0)),
        activation_dropout=float(get("activation_dropout", 0.0)),
    )


def _stack(layers: list) -> dict:
    """Per-layer dicts -> one dict of [L, ...] leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return np.stack([np.asarray(x) for x in layers])


def _assemble(convs, sd, pos_conv, layers, *, post_ln, proj, final_ln):
    return {
        "feature_extractor": {"convs": convs},
        "post_extract_ln": _ln(sd, post_ln),
        "proj": _lin(sd, proj),
        "pos_conv": pos_conv,
        "encoder": {"layers": _stack(layers), "final_ln": _ln(sd, final_ln)},
    }


def from_fairseq_state_dict(sd: StateDict, cfg: XLSRConfig) -> Dict[str, Any]:
    """Map a fairseq ``Wav2Vec2Model`` state dict (the ``model`` entry of
    ``xlsr2_300m.pt``) to the XLS-R tree.

    fairseq key scheme (extractor_mode='layer_norm'):
      feature_extractor.conv_layers.{i}.0.*     conv
      feature_extractor.conv_layers.{i}.2.1.*   per-block LayerNorm
      layer_norm.*                              post-extractor LN
      post_extract_proj.*                       512 -> 1024
      encoder.pos_conv.0.{weight_g,weight_v,bias}
      encoder.layers.{i}.self_attn.{q,k,v,out}_proj.*
      encoder.layers.{i}.{self_attn_layer_norm,fc1,fc2,final_layer_norm}.*
      encoder.layer_norm.*                      final LN
    """
    convs = [{"conv": _conv(sd, f"feature_extractor.conv_layers.{i}.0", cfg.conv_bias),
              "ln": _ln(sd, f"feature_extractor.conv_layers.{i}.2.1")}
             for i in range(len(cfg.conv_layers))]
    if "encoder.pos_conv.0.weight_g" in sd:
        g, v = "encoder.pos_conv.0.weight_g", "encoder.pos_conv.0.weight_v"
    else:  # the parametrized form of newer torch
        g = "encoder.pos_conv.0.parametrizations.weight.original0"
        v = "encoder.pos_conv.0.parametrizations.weight.original1"
    pos_conv = _weight_norm_conv(_np(sd[g]), _np(sd[v]), sd["encoder.pos_conv.0.bias"])
    layers = []
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}"
        layers.append({
            "ln_attn": _ln(sd, f"{pre}.self_attn_layer_norm"),
            "attn": {"q": _lin(sd, f"{pre}.self_attn.q_proj"),
                     "k": _lin(sd, f"{pre}.self_attn.k_proj"),
                     "v": _lin(sd, f"{pre}.self_attn.v_proj"),
                     "o": _lin(sd, f"{pre}.self_attn.out_proj")},
            "ln_ffn": _ln(sd, f"{pre}.final_layer_norm"),
            "fc1": _lin(sd, f"{pre}.fc1"),
            "fc2": _lin(sd, f"{pre}.fc2"),
        })
    return _assemble(convs, sd, pos_conv, layers, post_ln="layer_norm",
                     proj="post_extract_proj", final_ln="encoder.layer_norm")


def from_hf_state_dict(sd: StateDict, cfg: XLSRConfig) -> Dict[str, Any]:
    """Map a HuggingFace ``Wav2Vec2Model`` state dict (the stable-layer-norm
    variant, ``do_stable_layer_norm=True, feat_extract_norm='layer'``: the
    xls-r-300m architecture)."""
    sd = {k.removeprefix("wav2vec2."): v for k, v in sd.items()}
    convs = [{"conv": _conv(sd, f"feature_extractor.conv_layers.{i}.conv", cfg.conv_bias),
              "ln": _ln(sd, f"feature_extractor.conv_layers.{i}.layer_norm")}
             for i in range(len(cfg.conv_layers))]
    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in sd:
        pos_conv = _weight_norm_conv(_np(sd[f"{pc}.weight_g"]), _np(sd[f"{pc}.weight_v"]),
                                     sd[f"{pc}.bias"])
    elif f"{pc}.parametrizations.weight.original0" in sd:
        pos_conv = _weight_norm_conv(
            _np(sd[f"{pc}.parametrizations.weight.original0"]),
            _np(sd[f"{pc}.parametrizations.weight.original1"]), sd[f"{pc}.bias"])
    else:  # already contracted
        pos_conv = _conv(sd, pc)
    layers = []
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}"
        layers.append({
            "ln_attn": _ln(sd, f"{pre}.layer_norm"),
            "attn": {"q": _lin(sd, f"{pre}.attention.q_proj"),
                     "k": _lin(sd, f"{pre}.attention.k_proj"),
                     "v": _lin(sd, f"{pre}.attention.v_proj"),
                     "o": _lin(sd, f"{pre}.attention.out_proj")},
            "ln_ffn": _ln(sd, f"{pre}.final_layer_norm"),
            "fc1": _lin(sd, f"{pre}.feed_forward.intermediate_dense"),
            "fc2": _lin(sd, f"{pre}.feed_forward.output_dense"),
        })
    return _assemble(convs, sd, pos_conv, layers, post_ln="feature_projection.layer_norm",
                     proj="feature_projection.projection", final_ln="encoder.layer_norm")


def infer_config_from_fairseq_sd(sd: StateDict, like: XLSRConfig = None) -> XLSRConfig:
    """The architecture's dimensions from a fairseq wav2vec2 state dict.

    Conv strides and the head count are not in the weights' shapes, so they
    come from ``like`` (default: the XLS-R family's; every published XLS-R
    width has 16 heads, head_dim 64 is the guess only for unknown widths)."""
    base = like or XLSRConfig.xlsr_300m()
    n_layers = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(r"encoder\.layers\.(\d+)\.", k)))
    d = _np(sd["encoder.layer_norm.weight"]).shape[0]
    ffn = _np(sd["encoder.layers.0.fc1.weight"]).shape[0]
    n_convs = 1 + max(int(m.group(1)) for k in sd
                      if (m := re.match(r"feature_extractor\.conv_layers\.(\d+)\.", k)))
    conv_layers = []
    for i in range(n_convs):
        out_ch, _, kern = _np(sd[f"feature_extractor.conv_layers.{i}.0.weight"]).shape
        stride = base.conv_layers[i][2] if i < len(base.conv_layers) else 2
        conv_layers.append((out_ch, kern, stride))
    pos_w = None
    for k in ("encoder.pos_conv.0.weight_v",
              "encoder.pos_conv.0.parametrizations.weight.original1"):
        if k in sd:
            pos_w = _np(sd[k])
    # a d // 64 guess would split q/k/v across wrong head boundaries for the
    # 1B and 2B widths (head_dim 80 and 120)
    xlsr_heads = {1024: 16, 1280: 16, 1920: 16}
    heads = base.num_heads if d == base.encoder_dim else xlsr_heads.get(d, max(d // 64, 1))
    return XLSRConfig(
        conv_layers=tuple(conv_layers),
        conv_bias="feature_extractor.conv_layers.0.0.bias" in sd,
        encoder_dim=d,
        encoder_layers=n_layers,
        ffn_dim=ffn,
        num_heads=heads,
        pos_conv_kernel=pos_w.shape[2] if pos_w is not None else base.pos_conv_kernel,
        pos_conv_groups=d // pos_w.shape[1] if pos_w is not None else base.pos_conv_groups,
    )


def _reference_consumed_keys(cfg: XLSRConfig, ssl_sd: StateDict) -> set:
    """The keys :func:`from_reference_model_checkpoint` maps; everything
    else in the checkpoint is an extra (BN state, fairseq pretraining
    heads)."""
    keys = {"LL.weight", "LL.bias", "backend.m_utt_level.weight", "backend.m_utt_level.bias"}
    for slot in (0, 3, 6):
        keys |= {f"backend.m_frame_level.{slot}.weight", f"backend.m_frame_level.{slot}.bias"}
    s = "ssl_model.model."
    for i in range(len(cfg.conv_layers)):
        keys |= {f"{s}feature_extractor.conv_layers.{i}.0.weight",
                 f"{s}feature_extractor.conv_layers.{i}.2.1.weight",
                 f"{s}feature_extractor.conv_layers.{i}.2.1.bias"}
        if cfg.conv_bias:
            # mapped only when the importer maps it: with conv_bias=False and
            # a checkpoint that has biases, they stay extras for the way back
            keys.add(f"{s}feature_extractor.conv_layers.{i}.0.bias")
    for nm in ("layer_norm", "post_extract_proj"):
        keys |= {f"{s}{nm}.weight", f"{s}{nm}.bias"}
    pos = (("parametrizations.weight.original0", "parametrizations.weight.original1")
           if "encoder.pos_conv.0.weight_g" not in ssl_sd else ("weight_g", "weight_v"))
    keys |= {f"{s}encoder.pos_conv.0.{p}" for p in pos + ("bias",)}
    for i in range(cfg.encoder_layers):
        for nm in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                   "self_attn.out_proj", "self_attn_layer_norm", "fc1", "fc2",
                   "final_layer_norm"):
            keys |= {f"{s}encoder.layers.{i}.{nm}.weight", f"{s}encoder.layers.{i}.{nm}.bias"}
    keys |= {f"{s}encoder.layer_norm.weight", f"{s}encoder.layer_norm.bias"}
    return keys


def from_reference_model_checkpoint(sd: StateDict, cfg: XLSRConfig = None,
                                    like: XLSRConfig = None, return_extras: bool = False):
    """A reference ``epoch_N.pth`` (the whole ``wav2vec2_linear_nll`` state
    dict) -> (the LinearNLL parameter tree, XLSRConfig).

    The SSL weights come from the embedded fairseq model
    (``ssl_model.model.*``), the head from ``LL``,
    ``backend.m_frame_level.{0,3,6}`` and ``backend.m_utt_level``; the
    ``first_bn``/``first_bn1`` entries the reference declares and never
    runs are ignored.  ``module.``/``_orig_mod.`` prefixes must already be
    stripped (``train/checkpoint.load_reference_head_checkpoint``).

    ``cfg``: the SSL's XLSRConfig; by default read from the weights' shapes
    with ``like``'s strides.  ``return_extras``: also return the unmapped
    key -> tensor dict, so that :func:`to_reference_model_checkpoint`
    writes them back unchanged."""
    prefix = "ssl_model.model."
    ssl_sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not ssl_sd:
        raise ValueError("checkpoint has no ssl_model.model.* keys — not a full reference "
                         "wav2vec2_linear_nll state dict (head-only checkpoints need "
                         "--ssl_checkpoint for the SSL weights)")
    cfg = cfg or infer_config_from_fairseq_sd(ssl_sd, like)
    params = {
        "ssl": from_fairseq_state_dict(ssl_sd, cfg),
        "ll": _lin(sd, "LL"),
        "backend": {"frame": [_lin(sd, f"backend.m_frame_level.{i}") for i in (0, 3, 6)],
                    "out": _lin(sd, "backend.m_utt_level")},
    }
    if return_extras:
        consumed = _reference_consumed_keys(cfg, ssl_sd)
        return params, cfg, {k: v for k, v in sd.items() if k not in consumed}
    return params, cfg


def _torch_t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _lin_inv(p: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _torch_t(np.asarray(p["w"]).T)
    out[f"{prefix}.bias"] = _torch_t(p["b"])


def _ln_inv(p: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _torch_t(p["scale"])
    out[f"{prefix}.bias"] = _torch_t(p["bias"])


def _conv_inv(p: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _torch_t(np.transpose(np.asarray(p["w"]), (2, 1, 0)))
    if "b" in p:
        out[f"{prefix}.bias"] = _torch_t(p["b"])


def _unstack_layers(stacked) -> list:
    """Inverse of the stacking in ``_assemble``: split the layer axis."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    n = int(np.asarray(stacked["fc1"]["w"]).shape[0])
    return [take(stacked, i) for i in range(n)]


def to_fairseq_state_dict(ssl_params: Mapping[str, Any]) -> Dict[str, Any]:
    """XLS-R tree -> fairseq ``Wav2Vec2Model`` state dict (fp32 tensors), the
    exact inverse of :func:`from_fairseq_state_dict`.

    The positional conv is split again into torch ``weight_norm``'s (g, v)
    with v = w and g = ||w||_(0,1): the contraction g * v / ||v|| gives the
    kernel back bit for bit, but the original checkpoint's (g, v) is not
    recoverable (only the product survives conversion)."""
    sd: Dict[str, Any] = {}
    for i, blk in enumerate(ssl_params["feature_extractor"]["convs"]):
        _conv_inv(blk["conv"], f"feature_extractor.conv_layers.{i}.0", sd)
        _ln_inv(blk["ln"], f"feature_extractor.conv_layers.{i}.2.1", sd)
    _ln_inv(ssl_params["post_extract_ln"], "layer_norm", sd)
    _lin_inv(ssl_params["proj"], "post_extract_proj", sd)
    w_t = np.transpose(np.asarray(ssl_params["pos_conv"]["w"], dtype=np.float32), (2, 1, 0))
    g = np.sqrt(np.sum(w_t.astype(np.float64) ** 2, axis=(0, 1), keepdims=True))
    sd["encoder.pos_conv.0.weight_g"] = _torch_t(g)
    sd["encoder.pos_conv.0.weight_v"] = _torch_t(w_t)
    sd["encoder.pos_conv.0.bias"] = _torch_t(ssl_params["pos_conv"]["b"])
    for i, lp in enumerate(_unstack_layers(ssl_params["encoder"]["layers"])):
        pre = f"encoder.layers.{i}"
        _ln_inv(lp["ln_attn"], f"{pre}.self_attn_layer_norm", sd)
        _lin_inv(lp["attn"]["q"], f"{pre}.self_attn.q_proj", sd)
        _lin_inv(lp["attn"]["k"], f"{pre}.self_attn.k_proj", sd)
        _lin_inv(lp["attn"]["v"], f"{pre}.self_attn.v_proj", sd)
        _lin_inv(lp["attn"]["o"], f"{pre}.self_attn.out_proj", sd)
        _ln_inv(lp["ln_ffn"], f"{pre}.final_layer_norm", sd)
        _lin_inv(lp["fc1"], f"{pre}.fc1", sd)
        _lin_inv(lp["fc2"], f"{pre}.fc2", sd)
    _ln_inv(ssl_params["encoder"]["final_ln"], "encoder.layer_norm", sd)
    return sd


def _bn2d_defaults(n: int, prefix: str, out: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = torch.ones(n)
    out[f"{prefix}.bias"] = torch.zeros(n)
    out[f"{prefix}.running_mean"] = torch.zeros(n)
    out[f"{prefix}.running_var"] = torch.ones(n)
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def to_reference_model_checkpoint(params: Mapping[str, Any], extras: Mapping[str, Any] = None,
                                  pretraining_stubs: bool = True) -> Dict[str, Any]:
    """LinearNLL parameter tree -> reference ``epoch_N.pth`` state dict, the
    inverse of :func:`from_reference_model_checkpoint`, so that a model
    trained here runs in the unmodified reference stack.

    It writes every key the reference ``Model`` declares: the fairseq SSL
    as ``ssl_model.model.*``, the head, and ``first_bn``/``first_bn1`` at
    torch's defaults.  ``pretraining_stubs``: fairseq's ``Wav2Vec2Model``
    also declares its pretraining heads (``mask_emb``, ``quantizer``,
    ``project_q``, ``final_proj``), which a strict ``load_state_dict``
    requires; they are written as zeros shaped for the published XLS-R
    pretraining config (final_dim 768, 2 groups x 320 codewords).
    ``extras`` (applied last) carries a converted checkpoint's own
    tensors back unchanged."""
    ssl_sd = to_fairseq_state_dict(params["ssl"])
    sd: Dict[str, Any] = {f"ssl_model.model.{k}": v for k, v in ssl_sd.items()}
    _lin_inv(params["ll"], "LL", sd)
    for slot, lp in zip((0, 3, 6), params["backend"]["frame"]):
        _lin_inv(lp, f"backend.m_frame_level.{slot}", sd)
    _lin_inv(params["backend"]["out"], "backend.m_utt_level", sd)
    _bn2d_defaults(1, "first_bn", sd)
    _bn2d_defaults(64, "first_bn1", sd)
    if pretraining_stubs:
        d = int(np.asarray(params["ssl"]["post_extract_ln"]["scale"]).shape[0])
        ext = int(np.asarray(
            params["ssl"]["feature_extractor"]["convs"][-1]["ln"]["scale"]).shape[0])
        final_dim, groups, vars_ = 768, 2, 320
        if d != 1024 and not (extras and "ssl_model.model.mask_emb" in extras):
            warnings.warn(
                f"pretraining-head stubs assume the published XLS-R-300m geometry "
                f"(final_dim=768, 2x320 codewords) but this SSL has encoder_dim={d}; a "
                f"strict reference load_state_dict may reject the stub shapes — pass "
                f"extras captured from a real checkpoint of this variant, or load with "
                f"strict=False", stacklevel=2)
        stub = {
            "mask_emb": torch.zeros(d),
            "quantizer.vars": torch.zeros(1, groups * vars_, final_dim // groups),
            "quantizer.weight_proj.weight": torch.zeros(groups * vars_, ext),
            "quantizer.weight_proj.bias": torch.zeros(groups * vars_),
            "project_q.weight": torch.zeros(final_dim, final_dim),
            "project_q.bias": torch.zeros(final_dim),
            "final_proj.weight": torch.zeros(final_dim, d),
            "final_proj.bias": torch.zeros(final_dim),
        }
        for k, v in stub.items():
            sd.setdefault(f"ssl_model.model.{k}", v)
    for k, v in (extras or {}).items():
        sd[k] = v if hasattr(v, "dim") else torch.from_numpy(np.asarray(v))
    return sd


def save_reference_checkpoint(params: Mapping[str, Any], path: str,
                              extras: Mapping[str, Any] = None) -> None:
    """Write a reference-loadable ``.pth`` (a torch pickle of the state dict)."""
    torch.save(to_reference_model_checkpoint(params, extras=extras), path)


def load_fairseq_checkpoint(path: str):
    """``xlsr2_300m.pt`` (a torch pickle) -> (SSL tree, XLSRConfig)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    try:  # fairseq's OmegaConf configs read as mappings after this cast
        from omegaconf import OmegaConf

        if "cfg" in ckpt and not isinstance(ckpt["cfg"], dict):
            ckpt = dict(ckpt)
            ckpt["cfg"] = OmegaConf.to_container(ckpt["cfg"], resolve=True)
    except ImportError:
        pass
    cfg = config_from_fairseq(ckpt)
    return from_fairseq_state_dict(sd, cfg), cfg


def load_hf_pretrained(name_or_path: str = "facebook/wav2vec2-xls-r-300m"):
    """A HuggingFace wav2vec2 model directory -> (SSL tree, XLSRConfig).
    Needs the ``transformers`` package, imported here."""
    from transformers import Wav2Vec2Model

    model = Wav2Vec2Model.from_pretrained(name_or_path)
    cfg = config_from_hf(model.config)
    return from_hf_state_dict(model.state_dict(), cfg), cfg


def config_from_hf(hf) -> XLSRConfig:
    return XLSRConfig(
        conv_layers=tuple((d, k, s) for d, k, s in zip(hf.conv_dim, hf.conv_kernel,
                                                       hf.conv_stride)),
        conv_bias=bool(hf.conv_bias),
        encoder_dim=int(hf.hidden_size),
        encoder_layers=int(hf.num_hidden_layers),
        ffn_dim=int(hf.intermediate_size),
        num_heads=int(hf.num_attention_heads),
        pos_conv_kernel=int(hf.num_conv_pos_embeddings),
        pos_conv_groups=int(hf.num_conv_pos_embedding_groups),
        layer_norm_eps=float(hf.layer_norm_eps),
        dropout=float(hf.hidden_dropout),
        attention_dropout=float(hf.attention_dropout),
        activation_dropout=float(hf.activation_dropout),
    )
