"""The port's checkpoint converters (``models/convert.py``) and reference
``.pth`` loading, against the JAX package's on the CPU.

Every importer must give the JAX importer's tree leaf for leaf
(``np.array_equal``), every exporter the JAX exporter's state dict byte for
byte, on the same inputs: a random-init HuggingFace ``Wav2Vec2Model`` built
from a local ``Wav2Vec2Config`` (as ``tests/test_convert_hf.py`` builds
one), synthetic fairseq and reference state dicts made with numpy from a
seed, and the golden checkpoint, whose reference ``.pth`` must score the
golden scores.  The CLI loads a ``.pth`` (``--model_path``), writes one
(``--export_reference_ckpt``) and loads SSL weights (``--ssl_checkpoint``)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from scl_deepfake_audio_detection_tpu.models import convert as jconvert
from scl_deepfake_audio_detection_tpu.models import xlsr as JX
from scl_deepfake_audio_detection_tpu.train import checkpoint as jckpt
from scl_deepfake_audio_detection_torch.cli import main as port_main
from scl_deepfake_audio_detection_torch.models import convert as pconvert
from scl_deepfake_audio_detection_torch.models import xlsr as PX
from scl_deepfake_audio_detection_torch.models.linear_nll import LinearNLL
from scl_deepfake_audio_detection_torch.models.params import load_jax_params, to_jax
from scl_deepfake_audio_detection_torch.train import checkpoint as pckpt
from scl_deepfake_audio_detection_torch.train.engine import score_step
from scl_deepfake_audio_detection_torch.utils.audio_io import save_wav
from scl_deepfake_audio_detection_torch.utils.tree import flatten

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
ATOL_GOLDEN = 1e-4  # as tests/test_golden_pipeline.py
SR = 16000


def _assert_trees_equal(got, want):
    """Leaf for leaf: the same paths, dtypes and bits."""
    g, w = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def _assert_state_dicts_equal(got, want):
    """Byte for byte: the same keys, dtypes, shapes and bytes."""
    assert list(got) == list(want)
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.numpy().tobytes() == b.numpy().tobytes(), k


def _fairseq_sd(cfg, rng):
    """A fairseq wav2vec2 state dict for ``cfg`` (the key scheme of
    ``from_fairseq_state_dict``), fp32 numpy from ``rng``."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    sd = {}
    for i, (dim, k, _) in enumerate(cfg.conv_layers):
        cin = 1 if i == 0 else cfg.conv_layers[i - 1][0]
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = f32(rng.normal(size=(dim, cin, k)) * .1)
        sd[f"feature_extractor.conv_layers.{i}.0.bias"] = f32(rng.normal(size=dim) * .1)
        sd[f"feature_extractor.conv_layers.{i}.2.1.weight"] = f32(1 + rng.normal(size=dim) * .1)
        sd[f"feature_extractor.conv_layers.{i}.2.1.bias"] = f32(rng.normal(size=dim) * .1)
    c, d = cfg.conv_layers[-1][0], cfg.encoder_dim
    sd["layer_norm.weight"] = f32(1 + rng.normal(size=c) * .1)
    sd["layer_norm.bias"] = f32(rng.normal(size=c) * .1)
    sd["post_extract_proj.weight"] = f32(rng.normal(size=(d, c)) * .1)
    sd["post_extract_proj.bias"] = f32(rng.normal(size=d) * .1)
    sd["encoder.pos_conv.0.weight_g"] = f32(1 + rng.random((1, 1, cfg.pos_conv_kernel)))
    sd["encoder.pos_conv.0.weight_v"] = f32(
        rng.normal(size=(d, d // cfg.pos_conv_groups, cfg.pos_conv_kernel)) * .1)
    sd["encoder.pos_conv.0.bias"] = f32(rng.normal(size=d) * .1)
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{name}.weight"] = f32(rng.normal(size=(d, d)) * .1)
            sd[f"{pre}.self_attn.{name}.bias"] = f32(rng.normal(size=d) * .1)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{pre}.{name}.weight"] = f32(1 + rng.normal(size=d) * .1)
            sd[f"{pre}.{name}.bias"] = f32(rng.normal(size=d) * .1)
        sd[f"{pre}.fc1.weight"] = f32(rng.normal(size=(cfg.ffn_dim, d)) * .1)
        sd[f"{pre}.fc1.bias"] = f32(rng.normal(size=cfg.ffn_dim) * .1)
        sd[f"{pre}.fc2.weight"] = f32(rng.normal(size=(d, cfg.ffn_dim)) * .1)
        sd[f"{pre}.fc2.bias"] = f32(rng.normal(size=d) * .1)
    sd["encoder.layer_norm.weight"] = f32(1 + rng.normal(size=d) * .1)
    sd["encoder.layer_norm.bias"] = f32(rng.normal(size=d) * .1)
    return sd


def _reference_sd(cfg, rng, emb=16):
    """A reference ``wav2vec2_linear_nll`` state dict: the SSL under
    ``ssl_model.model.``, the head, and the BatchNorm entries a real
    ``epoch_N.pth`` carries, non-default so that their passage shows."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    sd = {f"ssl_model.model.{k}": v for k, v in _fairseq_sd(cfg, rng).items()}
    d = cfg.encoder_dim
    sd["LL.weight"] = f32(rng.normal(size=(emb, d)) * .1)
    sd["LL.bias"] = f32(rng.normal(size=emb) * .1)
    for i in (0, 3, 6):
        sd[f"backend.m_frame_level.{i}.weight"] = f32(rng.normal(size=(emb, emb)) * .1)
        sd[f"backend.m_frame_level.{i}.bias"] = f32(rng.normal(size=emb) * .1)
    sd["backend.m_utt_level.weight"] = f32(rng.normal(size=(2, emb)) * .1)
    sd["backend.m_utt_level.bias"] = f32(rng.normal(size=2) * .1)
    sd["first_bn.running_mean"] = f32([0.25])
    sd["first_bn.num_batches_tracked"] = np.asarray(3)
    sd["ssl_model.model.mask_emb"] = f32(rng.normal(size=d))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


# ------------------------------------------------------------- HuggingFace


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2),
        conv_stride=(5, 2, 2), conv_bias=True, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, do_stable_layer_norm=True,
        feat_extract_norm="layer", feat_extract_activation="gelu", hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
        layerdrop=0.0, apply_spec_augment=False)
    torch.manual_seed(0)
    return transformers.Wav2Vec2Model(hf_cfg).eval()


def test_config_from_hf_matches_jax(hf_model):
    got = pconvert.config_from_hf(hf_model.config)
    want = jconvert.config_from_hf(hf_model.config)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_from_hf_state_dict_matches_jax_leaf_for_leaf(hf_model):
    cfg = pconvert.config_from_hf(hf_model.config)
    sd = hf_model.state_dict()
    _assert_trees_equal(pconvert.from_hf_state_dict(sd, cfg),
                        jconvert.from_hf_state_dict(sd, jconvert.config_from_hf(hf_model.config)))


def test_hf_weights_score_in_the_port_as_in_hf(hf_model):
    """The converted tree in the port's XLS-R gives HF's frame features
    (fp32; the feature encoder at the JAX test's 2e-5, the transformer at
    its 5e-4)."""
    cfg = pconvert.config_from_hf(hf_model.config)
    model = load_jax_params(PX.XLSR(cfg), pconvert.from_hf_state_dict(
        hf_model.state_dict(), cfg)).eval()
    wav = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3200)).astype(np.float32)
                           * 0.1)
    with torch.inference_mode():
        feats = model.feature_encoder(wav)
        out = model.extract_features(wav)
        want_feats = hf_model.feature_extractor(wav).transpose(1, 2)
        want = hf_model(wav).last_hidden_state
    np.testing.assert_allclose(feats.numpy(), want_feats.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=5e-4, rtol=0)


# ----------------------------------------------------------------- fairseq


def test_fairseq_import_and_export_match_jax():
    cfg_j, cfg_p = JX.XLSRConfig.tiny(), PX.XLSRConfig.tiny()
    sd = _fairseq_sd(cfg_p, np.random.default_rng(3))
    got = pconvert.from_fairseq_state_dict(sd, cfg_p)
    want = jconvert.from_fairseq_state_dict(sd, cfg_j)
    _assert_trees_equal(got, want)
    _assert_state_dicts_equal(pconvert.to_fairseq_state_dict(got),
                              jconvert.to_fairseq_state_dict(want))
    # and back: the round trip gives the tree again (the pos conv's (g, v)
    # split is canonical, the contraction the same within one rounding)
    again = pconvert.from_fairseq_state_dict(
        {k: v.numpy() for k, v in pconvert.to_fairseq_state_dict(got).items()}, cfg_p)
    for k, v in flatten(got).items():
        np.testing.assert_allclose(flatten(again)[k], v, atol=1e-6, rtol=0, err_msg=k)


def test_fairseq_configs_match_jax():
    sd = _fairseq_sd(PX.XLSRConfig.tiny(), np.random.default_rng(4))
    for like in (None, "tiny"):
        got = pconvert.infer_config_from_fairseq_sd(
            sd, like and PX.XLSRConfig.tiny())
        want = jconvert.infer_config_from_fairseq_sd(sd, like and JX.XLSRConfig.tiny())
        assert dataclasses.asdict(got) == {f: getattr(want, f) for f in dataclasses.asdict(got)}
    ckpt = {"cfg": {"model": {"conv_feature_layers": "[(16, 10, 5)] + [(16, 3, 2)] * 2",
                              "encoder_embed_dim": 32, "encoder_layers": 2,
                              "encoder_ffn_embed_dim": 64, "encoder_attention_heads": 4,
                              "conv_pos": 16, "conv_pos_groups": 4, "dropout": 0.1}}}
    for c in (ckpt, {}):
        got, want = pconvert.config_from_fairseq(c), jconvert.config_from_fairseq(c)
        assert dataclasses.asdict(got) == {f: getattr(want, f) for f in dataclasses.asdict(got)}


def test_load_fairseq_checkpoint_matches_jax(tmp_path):
    cfg = PX.XLSRConfig.tiny()
    sd = {k: torch.from_numpy(v) for k, v in _fairseq_sd(cfg, np.random.default_rng(5)).items()}
    path = str(tmp_path / "xlsr.pt")
    torch.save({"model": sd, "cfg": {"model": {
        "conv_feature_layers": str(list(cfg.conv_layers)), "encoder_embed_dim": 32,
        "encoder_layers": 2, "encoder_ffn_embed_dim": 64, "encoder_attention_heads": 4,
        "conv_pos": 16, "conv_pos_groups": 4}}}, path)
    got, got_cfg = pconvert.load_fairseq_checkpoint(path)
    want, want_cfg = jconvert.load_fairseq_checkpoint(path)
    _assert_trees_equal(got, want)
    assert got_cfg.conv_layers == want_cfg.conv_layers == cfg.conv_layers


# --------------------------------------------------------------- reference


@pytest.mark.parametrize("conv_bias", [True, False])
def test_reference_checkpoint_import_matches_jax(conv_bias):
    """The tree, the config and the extras (BN state, pretraining heads,
    and the conv biases a conv_bias=False config leaves unmapped)."""
    sd = _reference_sd(PX.XLSRConfig.tiny(), np.random.default_rng(6))
    cfg_p = PX.XLSRConfig.tiny(conv_bias=conv_bias)
    cfg_j = JX.XLSRConfig.tiny(conv_bias=conv_bias)
    got, got_cfg, got_x = pconvert.from_reference_model_checkpoint(
        sd, cfg=cfg_p, return_extras=True)
    want, want_cfg, want_x = jconvert.from_reference_model_checkpoint(
        sd, cfg=cfg_j, return_extras=True)
    _assert_trees_equal(got, want)
    assert sorted(got_x) == sorted(want_x)
    assert ("first_bn.running_mean" in got_x
            and ("ssl_model.model.feature_extractor.conv_layers.0.0.bias" in got_x)
            == (not conv_bias))
    p2, cfg2 = pconvert.from_reference_model_checkpoint(sd, like=PX.XLSRConfig.tiny())
    assert cfg2.conv_layers == PX.XLSRConfig.tiny().conv_layers
    with pytest.raises(ValueError, match="ssl_model.model"):
        pconvert.from_reference_model_checkpoint({"LL.weight": np.zeros((2, 2))})


def test_to_reference_model_checkpoint_matches_jax_byte_for_byte():
    """With and without a converted checkpoint's extras; both packages warn
    alike that the pretraining stubs assume the 300M geometry, and only
    without extras."""
    import warnings

    sd = _reference_sd(PX.XLSRConfig.tiny(), np.random.default_rng(7))
    params, _, extras = pconvert.from_reference_model_checkpoint(
        sd, like=PX.XLSRConfig.tiny(), return_extras=True)
    for kw in ({}, {"extras": extras}):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = pconvert.to_reference_model_checkpoint(params, **kw)
            want = jconvert.to_reference_model_checkpoint(params, **kw)
        assert sum("XLS-R-300m" in str(w.message) for w in caught) == (0 if kw else 2)
        _assert_state_dicts_equal(got, want)
    # the extras come back as they went in
    assert torch.equal(got["first_bn.running_mean"], sd["first_bn.running_mean"])
    assert torch.equal(got["ssl_model.model.mask_emb"], sd["ssl_model.model.mask_emb"])


def test_load_reference_head_checkpoint_matches_jax(tmp_path):
    sd = _reference_sd(PX.XLSRConfig.tiny(), np.random.default_rng(8))
    sd = {("module." if i % 2 else "_orig_mod.") + k: v for i, (k, v) in enumerate(sd.items())}
    path = str(tmp_path / "epoch_3.pth")
    torch.save(sd, path)
    got, want = pckpt.load_reference_head_checkpoint(path), \
        jckpt.load_reference_head_checkpoint(path)
    assert list(got) == list(want) and not any(k.startswith("module.") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _golden_wavs(t=16000):
    rng = np.random.default_rng(20240817)
    tt = np.arange(t) / 16000.0
    return [(0.3 * np.sin(2 * np.pi * 440.0 * tt)).astype(np.float32),
            (0.2 * rng.normal(size=t)).astype(np.float32),
            (0.3 * np.sin(2 * np.pi * (200 + 800 * tt) * tt)).astype(np.float32),
            (0.25 * np.sin(2 * np.pi * 333.0 * tt[: t // 3])).astype(np.float32)]


def test_reference_pth_of_the_golden_checkpoint_scores_the_golden(tmp_path):
    """The golden checkpoint written as a reference ``.pth`` by the port
    (byte for byte the JAX package's), read back and scored: the golden
    scores within 1e-4, and the scores of the ``.ckpt`` within 1e-6."""
    from scl_deepfake_audio_detection_torch.data.datasets import EvalDataset
    from scl_deepfake_audio_detection_torch.data.loader import EvalLoader
    from scl_deepfake_audio_detection_torch.train import scoring

    tree, _ = pckpt.load(os.path.join(GOLDEN, "mini_linear_nll.ckpt"))
    pth = str(tmp_path / "epoch_0.pth")
    with pytest.warns(UserWarning, match="XLS-R-300m"):
        pconvert.save_reference_checkpoint(tree["params"], pth)
    with pytest.warns(UserWarning, match="XLS-R-300m"):
        want_sd = jconvert.to_reference_model_checkpoint(tree["params"])
    _assert_state_dicts_equal(torch.load(pth, weights_only=False), want_sd)

    params, _ = pconvert.from_reference_model_checkpoint(
        pckpt.load_reference_head_checkpoint(pth), like=PX.XLSRConfig.tiny())
    utts = []
    for i, w in enumerate(_golden_wavs()):
        save_wav(str(tmp_path / "eval" / f"g{i}.wav"), w, SR)
        utts.append(f"g{i}.wav")
    rows = {}
    for name, p in (("pth", params), ("ckpt", tree["params"])):
        model = load_jax_params(LinearNLL(ssl=PX.XLSRConfig.tiny(), emb_dim=16, device="cpu"),
                                p).eval()
        loader = EvalLoader(EvalDataset(utts, str(tmp_path), padding_type="repeat", cut=16000),
                            batch_size=2, num_workers=1)
        out = str(tmp_path / f"{name}.txt")
        scoring.produce_evaluation_file(loader, lambda wav, m=model: score_step(m, wav), out)
        rows[name] = open(out).read()
    # the positional conv's (g, v) split and contraction round once in fp32
    np.testing.assert_allclose(
        np.array([ln.split()[1:] for ln in rows["pth"].splitlines()], float),
        np.array([ln.split()[1:] for ln in rows["ckpt"].splitlines()], float),
        atol=1e-6, rtol=0)
    want = [ln.split() for ln in open(os.path.join(GOLDEN, "expected_scores.txt"))]
    got = [ln.split() for ln in rows["pth"].splitlines()]
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose(np.array([g[1:] for g in got], float),
                               np.array([w[1:] for w in want], float), atol=ATOL_GOLDEN, rtol=0)


# --------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_db(tmp_path_factory):
    """An eval-only database of three clips and a reference ``.pth`` of a
    tiny model with the conf-N head width (emb 128)."""
    root = tmp_path_factory.mktemp("convert_db")
    rng = np.random.default_rng(9)
    lines = []
    for i in range(3):
        save_wav(str(root / f"c{i}.wav"),
                 (0.2 * rng.normal(size=int(rng.integers(5000, 9000)))).astype(np.float32), SR)
        lines.append(f"c{i}.wav eval {'bonafide' if i % 2 else 'spoof'}")
    (root / "protocol.txt").write_text("\n".join(lines) + "\n")
    pth = str(root / "epoch_1.pth")
    torch.save(_reference_sd(PX.XLSRConfig.tiny(), np.random.default_rng(10), emb=128), pth)
    return root, pth


def _cli(root, *argv):
    return ["--config", os.path.join(REPO, "configs", "conf-eval-only.yaml"),
            "--database_path", str(root), "--ssl_preset", "tiny", "--compute_dtype",
            "float32", "--device", "cpu", "--num_workers", "1", *argv]


def test_cli_scores_a_reference_pth_and_writes_it_back(cli_db, tmp_path, capsys):
    """``--model_path epoch_1.pth`` scores as the JAX CLI does (1e-5), and
    ``--export_reference_ckpt`` writes it back with its extras: a ``.pth``
    whose mapped weights and extras equal the input's, scoring identically."""
    from scl_deepfake_audio_detection_tpu.cli import main as jax_main

    root, pth = cli_db
    out = str(tmp_path / "port.txt")
    assert port_main(_cli(root, "--eval", "--model_path", pth, "--eval_output", out)) == 0
    assert "loaded reference checkpoint" in capsys.readouterr().out
    jout = str(tmp_path / "jax.txt")
    assert jax_main([a for a in _cli(root, "--eval", "--model_path", pth, "--eval_output",
                                     jout) if a not in ("--device", "cpu")]) == 0
    got = [ln.split() for ln in open(out)]
    want = [ln.split() for ln in open(jout)]
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose(np.array([g[1:] for g in got], float),
                               np.array([w[1:] for w in want], float), atol=1e-5, rtol=0)

    back = str(tmp_path / "back.pth")
    assert port_main(_cli(root, "--model_path", pth, "--export_reference_ckpt", back)) == 0
    assert "extras round-tripped" in capsys.readouterr().out
    orig, new = torch.load(pth, weights_only=False), torch.load(back, weights_only=False)
    assert set(new) >= set(orig)
    for k, v in orig.items():
        if ".pos_conv.0.weight_" not in k:  # (g, v) is split again canonically
            assert torch.equal(new[k].to(v.dtype), v), k
    out2 = str(tmp_path / "back.txt")
    assert port_main(_cli(root, "--eval", "--model_path", back, "--eval_output", out2)) == 0
    np.testing.assert_allclose(np.array([ln.split()[1:] for ln in open(out2)], float),
                               np.array([g[1:] for g in got], float), atol=1e-6, rtol=0)


def test_cli_export_reference_ckpt_needs_a_checkpoint(cli_db, tmp_path, capsys):
    root, _ = cli_db
    assert port_main(_cli(root, "--export_reference_ckpt", str(tmp_path / "x.pth"))) == 2
    assert "needs --model_path" in capsys.readouterr().err


def test_cli_ssl_checkpoint_loads_fairseq_weights(cli_db, tmp_path, monkeypatch):
    """``--ssl_checkpoint x.pt`` puts a fairseq checkpoint's weights into
    the SSL frontend over the seeded init (the head keeps its init)."""
    import scl_deepfake_audio_detection_torch.cli.evaluate as evaluate

    root, _ = cli_db
    cfg = PX.XLSRConfig.tiny()
    sd = _fairseq_sd(cfg, np.random.default_rng(11))
    pt = str(tmp_path / "xlsr.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "cfg": {"model": {
        "conv_feature_layers": str(list(cfg.conv_layers)), "encoder_embed_dim": 32,
        "encoder_layers": 2, "encoder_ffn_embed_dim": 64, "encoder_attention_heads": 4,
        "conv_pos": 16, "conv_pos_groups": 4}}}, pt)
    seen = {}

    def grab(args, ctx):
        seen["ssl"] = to_jax(ctx.model.ssl)
        seen["ll"] = ctx.model.ll.weight.detach().clone()
        return 0

    monkeypatch.setattr(evaluate, "run", grab)
    assert port_main(_cli(root, "--eval", "--ssl_checkpoint", pt)) == 0
    want = jconvert.from_fairseq_state_dict(sd, JX.XLSRConfig.tiny())
    _assert_trees_equal(seen["ssl"], want)
    fresh = LinearNLL(ssl=cfg, device="cpu", seed=1234)  # --seed's default
    assert torch.equal(seen["ll"], fresh.ll.weight)


def test_cli_ssl_checkpoint_hf_dir(cli_db, hf_model, tmp_path, monkeypatch, capsys):
    """An HF model directory loads through transformers; without the package
    the CLI exits 2 and names it."""
    import importlib.util

    import scl_deepfake_audio_detection_torch.cli.common as common
    import scl_deepfake_audio_detection_torch.cli.evaluate as evaluate

    root, _ = cli_db
    hf_dir = str(tmp_path / "hf")
    hf_model.save_pretrained(hf_dir)
    seen = {}

    def grab(args, ctx):
        seen["ssl"] = to_jax(ctx.model.ssl)
        return 0

    monkeypatch.setattr(evaluate, "run", grab)
    assert port_main(_cli(root, "--eval", "--ssl_checkpoint", hf_dir)) == 0
    _assert_trees_equal(seen["ssl"], jconvert.from_hf_state_dict(
        hf_model.state_dict(), jconvert.config_from_hf(hf_model.config)))
    real = importlib.util.find_spec
    monkeypatch.setattr(common.importlib.util, "find_spec",
                        lambda name, *a: None if name == "transformers" else real(name, *a))
    capsys.readouterr()
    assert port_main(_cli(root, "--eval", "--ssl_checkpoint", hf_dir)) == 2
    assert "transformers" in capsys.readouterr().err
