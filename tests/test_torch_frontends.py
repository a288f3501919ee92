"""The embedding front ends (`repro_torch.models.frontends`, the configs
musicgen-large and pixtral-12b, `input_kind == "embeddings"` in
`models/transformer.py` and `launch/serve.py`) against the reference's, at
reduced width (3 layers, d_model 128) on the same numpy inputs, the
reference run under `jax.jit`.

Tolerances (float32), and why:
  * the codebook sum: equal (the same float32 rows added in the same
    order); the patch projection within 1e-6 in relative norm (a float32
    product over patch_dim 768, summed in another order);
  * prefill and forward logits within 1e-4, decode logits within 1e-4 on
    a raw ring and 2e-2 on the quantized one (read through bf16 on both
    sides, ROADMAP C5), ring codes equal at >= 0.999, as
    `tests/test_torch_serve.py` holds the token models;
  * `loss_fn` and one `make_train_step` step as `tests/test_torch_train.py`
    holds them (loss 1e-5 relative, gradients 1e-4 in relative norm); the
    untied `embed`, which an embeddings model does not read, gets a zero
    gradient on both sides;
  * greedy tokens of `serve()` equal: both feed each token back as its
    `embed` row rounded to bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget
from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.models import frontends as rfront
from repro.models import transformer as rt
from repro.optim import AdamWConfig as RAdamWConfig
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import frontends as tfront
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (frontend_params_from_numpy, named_to_tree, params_from_numpy,
                                        params_to_numpy)
from repro_torch.optim import AdamWConfig

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

ARCHS = ("musicgen-large", "pixtral-12b")
#: the reference's parameter counts, in billions to two places
PARAMS_B = {"musicgen-large": 3.23, "pixtral-12b": 12.25}
B, S, GEN = 2, 150, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _embeddings(arch: str, d_model: int, b: int, s: int, seed: int) -> np.ndarray:
    """(b, s, d_model) float32 prompts from the reference's front end of
    `arch`: seeded EnCodec codes through the codebook sum, or seeded
    patches through the projection."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    if arch == "musicgen-large":
        p = rfront.init_audio_frontend(key, tfront.AUDIO_CODEBOOKS, tfront.AUDIO_CODEBOOK_SIZE, d_model)
        codes = rng.integers(0, tfront.AUDIO_CODEBOOK_SIZE, (b, s, tfront.AUDIO_CODEBOOKS)).astype(np.int32)
        return np.array(rfront.audio_frames_to_embeddings(p, jnp.asarray(codes)))
    p = rfront.init_vision_frontend(key, tfront.VISION_PATCH_DIM, d_model)
    patches = rng.normal(size=(b, s, tfront.VISION_PATCH_DIM)).astype(np.float32)
    return np.array(rfront.patches_to_embeddings(p, jnp.asarray(patches)))


# -------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ARCHS)
def test_get_arch_returns_the_reference_config(arch):
    got, want = get_arch(arch), rget(arch)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert (got.source, got.skips, got.notes) == (want.source, want.skips, want.notes)
    assert got.model.input_kind == "embeddings"
    assert got.model.param_count() == want.model.param_count()
    assert round(got.model.param_count() / 1e9, 2) == PARAMS_B[arch]


def test_full_configs_build_on_the_meta_device():
    """musicgen-large (48 layers, 32 heads of 64 over 32) and pixtral-12b
    (40 layers, 32 heads of 128 over 8) at full width on the meta device:
    the reference's parameter count, the embedding table kept."""
    for arch in ARCHS:
        cfg = get_arch(arch).model
        model = tt.Transformer(cfg, "meta")
        shapes = jax.eval_shape(lambda k: rt.init_params(rget(arch).model, k), jax.random.PRNGKey(0))
        assert sum(p.numel() for p in model.parameters()) == sum(
            int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
        assert len(model.layers) == cfg.n_layers and model.embed.shape == (cfg.padded_vocab, cfg.d_model)
        assert model.layers[0].attn.wq.shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)


# ------------------------------------------------------------ front ends --
def test_audio_frontend_matches_reference():
    """The codebook sum of the reference's codebooks, carried across, on
    the same codes: equal in float32."""
    d_model = 64
    p = rfront.init_audio_frontend(jax.random.PRNGKey(3), tfront.AUDIO_CODEBOOKS, tfront.AUDIO_CODEBOOK_SIZE,
                                   d_model)
    codes = np.random.default_rng(4).integers(0, tfront.AUDIO_CODEBOOK_SIZE, (3, 17, 4)).astype(np.int32)
    want = np.asarray(jax.jit(rfront.audio_frames_to_embeddings)(p, jnp.asarray(codes)))
    tp = frontend_params_from_numpy(_np_tree(p), device="cpu")
    got = tfront.audio_frames_to_embeddings(tp, torch.from_numpy(codes))
    assert got.shape == (3, 17, d_model) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_vision_frontend_matches_reference():
    d_model = 96
    p = rfront.init_vision_frontend(jax.random.PRNGKey(5), tfront.VISION_PATCH_DIM, d_model)
    patches = np.random.default_rng(6).normal(size=(2, 33, tfront.VISION_PATCH_DIM)).astype(np.float32)
    want = np.asarray(jax.jit(rfront.patches_to_embeddings)(p, jnp.asarray(patches)))
    got = tfront.patches_to_embeddings(frontend_params_from_numpy(_np_tree(p), device="cpu"),
                                       torch.from_numpy(patches))
    assert got.shape == (2, 33, d_model)
    assert _rel(got.numpy(), want) <= 1e-6


def test_frontend_inits_draw_the_reference_distributions():
    """Shapes, dtypes and scales as the reference's (N(0, 1) / sqrt of the
    input width), and the same numbers from the same generator seed."""
    gen = lambda: torch.Generator().manual_seed(0)
    audio = tfront.init_audio_frontend(4, 2048, 128, generator=gen(), device="cpu")["codebooks"]
    ref_audio = rfront.init_audio_frontend(jax.random.PRNGKey(0), 4, 2048, 128)["codebooks"]
    assert audio.shape == ref_audio.shape == (4, 2048, 128) and audio.dtype == torch.float32
    assert abs(audio.std().item() * np.sqrt(128) - 1) < 0.01
    assert abs(float(jnp.std(ref_audio)) * np.sqrt(128) - 1) < 0.01
    proj = tfront.init_vision_frontend(768, 256, dtype=torch.bfloat16, generator=gen(), device="cpu")["proj"]
    assert proj.shape == (768, 256) and proj.dtype == torch.bfloat16
    assert abs(proj.float().std().item() * np.sqrt(768) - 1) < 0.01
    again = tfront.init_vision_frontend(768, 256, dtype=torch.bfloat16, generator=gen(), device="cpu")["proj"]
    assert torch.equal(proj, again)


# ------------------------------------------------------------- the model --
class Pair:
    """An embeddings config at reduced width: reference parameters, their
    port, jitted reference steps and front-end prompts."""

    def __init__(self, arch: str, **kw):
        self.arch = arch
        self.cfg = rget(arch).model.reduced(dtype="float32", **kw)
        self.tcfg = get_arch(arch).model.reduced(dtype="float32", **kw)
        self.params = rt.init_params(self.cfg, jax.random.PRNGKey(0))
        self.tree = _np_tree(self.params)
        self.model = params_from_numpy(self.tree, self.tcfg, "cpu")
        cfg = self.cfg
        self.prefill = jax.jit(lambda p, x, n: rt.prefill(p, cfg, x, n), static_argnums=2)
        self.decode = jax.jit(lambda p, c, x: rt.decode_step(p, cfg, c, x))
        self.prompts = _embeddings(arch, cfg.d_model, B, S, seed=1)
        toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (GEN, B))
        # the serve loop's decode inputs: embedding rows rounded to bf16
        self.steps = np.array(jnp.asarray(self.tree["embed"][toks][:, :, None]).astype(jnp.bfloat16)
                                .astype(jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module", params=ARCHS)
def raw_pair(request):
    return Pair(request.param, kv_quant=False)


def _port_cache(cache_r):
    return {"pos": int(cache_r["pos"]),
            "layers": {k: torch.from_numpy(np.array(v)) for k, v in cache_r["layers"].items()}}


def test_forward_matches_reference(pair):
    want, aux = jax.jit(lambda p, x: rt.forward(p, pair.cfg, x))(pair.params, jnp.asarray(pair.prompts))
    got, taux = tt.forward(pair.model, pair.tcfg, torch.from_numpy(pair.prompts))
    assert got.shape == (B, S, pair.tcfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4)
    assert taux.item() == float(aux) == 0.0


def _prefill_and_decode(p: Pair, decode_tol: float) -> None:
    cache_r, log_r = p.prefill(p.params, jnp.asarray(p.prompts), S + GEN)
    cache_t, log_t = tt.prefill(p.model, p.tcfg, torch.from_numpy(p.prompts), S + GEN)
    np.testing.assert_allclose(_np(log_t), np.asarray(log_r), rtol=0, atol=1e-4)
    assert cache_t["pos"] == int(cache_r["pos"]) == S
    for name, t in cache_t["layers"].items():
        r = np.asarray(cache_r["layers"][name])
        if t.dtype == torch.uint8:
            assert float((t.numpy() == r).mean()) >= 0.999, name
        else:
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-5, atol=1e-5, err_msg=name)
    carried = _port_cache(cache_r)
    for x in p.steps:
        cache_r, lr = p.decode(p.params, cache_r, jnp.asarray(x))
        carried, lt = tt.decode_step(p.model, p.tcfg, carried, torch.from_numpy(x))
        np.testing.assert_allclose(_np(lt), np.asarray(lr), rtol=0, atol=decode_tol)
    assert carried["pos"] == S + GEN


def test_prefill_and_decode_match_reference(pair):
    _prefill_and_decode(pair, 2e-2)


def test_prefill_and_decode_raw_cache_match_reference(raw_pair):
    _prefill_and_decode(raw_pair, 1e-4)


def test_loss_and_grads_match_reference(pair):
    """`loss_fn` on (B, S, D) embeddings: loss, ce and every gradient; the
    unread `embed` gets a zero gradient on both sides."""
    emb = pair.prompts[:, :24]
    labels = np.random.default_rng(8).integers(0, pair.cfg.vocab_size, (B, 24)).astype(np.int32)
    (loss, m), g = jax.jit(jax.value_and_grad(lambda p, b: rt.loss_fn(p, pair.cfg, b), has_aux=True))(
        pair.params, {"inputs": jnp.asarray(emb), "labels": jnp.asarray(labels)})
    model = params_from_numpy(pair.tree, pair.tcfg, "cpu", param_dtype="float32")
    tloss, tm = tt.loss_fn(model, pair.tcfg, {"inputs": _t(emb), "labels": _t(labels)})
    tloss.backward()
    assert abs(tloss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    assert abs(tm["ce"].item() - float(m["ce"])) <= 1e-5 * abs(float(m["ce"]))
    assert model.embed.grad is None and not np.asarray(g["embed"]).any()
    got = named_to_tree({k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                         for k, p in model.named_parameters()})
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np_tree(g))[0]:
        if leaf.any():
            assert _rel(_leaf(got, path), leaf) < 1e-4, path
        else:
            assert not _leaf(got, path).any(), path


def test_train_step_on_embeddings_matches_reference(pair):
    """One `make_train_step` step on embeddings: loss and grad norm, and the
    parameters after it (the untied `embed` moved by weight decay alone,
    from its zero gradient), as `tests/test_torch_train.py` holds them."""
    opt = dict(lr=1e-2, weight_decay=0.1)
    from repro.optim import adamw as radamw
    from repro_torch.optim import adamw as tadamw

    _, r_step = rsteps.make_train_step(pair.cfg, RAdamWConfig(**opt))
    _, t_step = tsteps.make_train_step(pair.tcfg, AdamWConfig(**opt), device="cpu")
    emb = pair.prompts[:, :17]
    labels = np.random.default_rng(9).integers(0, pair.cfg.vocab_size, (B, 17)).astype(np.int32)
    r_params, _, rm = jax.jit(r_step)(pair.params, radamw(RAdamWConfig(**opt))[0](pair.params),
                                      {"inputs": jnp.asarray(emb), "labels": jnp.asarray(labels)})
    model = params_from_numpy(pair.tree, pair.tcfg, "cpu", param_dtype="float32")
    t_opt = tadamw(AdamWConfig(**opt))[0](dict(model.named_parameters()))
    model, _, tm = t_step(model, t_opt, {"inputs": _t(emb), "labels": _t(labels)})
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-5 * abs(float(rm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-4 * float(rm["grad_norm"])
    got = params_to_numpy(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np_tree(r_params))[0]:
        d = np.abs(_leaf(got, path) - leaf)
        assert float((d > 1e-5).mean()) <= 1e-3 and d.mean() <= 1e-6, path
    np.testing.assert_allclose(got["embed"], pair.tree["embed"] * (1 - 1e-2 * 0.1), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_the_reference(arch):
    """`serve()` with the reference's own prompts (bf16 normals from its
    seed) and parameters: greedy tokens equal in float32, each fed back as
    its embed row rounded to bf16; cache bytes equal."""
    cfg = rget(arch).model.reduced(dtype="float32")
    tcfg = get_arch(arch).model.reduced(dtype="float32")
    batch, prompt_len, gen, seed = 2, 100, 6, 0
    run_r = rserve.serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed)
    key = jax.random.PRNGKey(seed)
    tree = _np_tree(rt.init_params(cfg, key))
    prompts = np.asarray(jax.random.normal(key, (batch, prompt_len, cfg.d_model), jnp.bfloat16)
                         .astype(jnp.float32))
    run_t = tserve.serve(tcfg, batch=batch, prompt_len=prompt_len, gen=gen, device="cpu", params=tree,
                         prompts=prompts)
    np.testing.assert_array_equal(run_t.tokens, run_r.tokens)
    assert run_t.cache_bytes == run_r.cache_bytes
    assert run_t.cache_bytes_raw_equiv == run_r.cache_bytes_raw_equiv


def test_serve_draws_bf16_embedding_prompts_and_feeds_bf16_rows(monkeypatch):
    """Without prompts `serve()` draws (B, S, D) bf16 normals from its seed;
    every decode input is a (B, 1, D) bf16 embedding row, also for a
    float32 model."""
    tcfg = get_arch("musicgen-large").model.reduced(dtype="float32")
    seen = []
    orig = tserve.make_prefill_step

    def spy_prefill(cfg, cache_seq_len=None):
        step = orig(cfg, cache_seq_len)
        return lambda model, x: seen.append(("prefill", x.shape, x.dtype)) or step(model, x)

    orig_serve = tserve.make_serve_step

    def spy_serve(cfg):
        step = orig_serve(cfg)
        return lambda model, cache, x: seen.append(("decode", x.shape, x.dtype)) or step(model, cache, x)

    monkeypatch.setattr(tserve, "make_prefill_step", spy_prefill)
    monkeypatch.setattr(tserve, "make_serve_step", spy_serve)
    run = tserve.serve(tcfg, batch=2, prompt_len=9, gen=3, device="cpu")
    assert run.tokens.shape == (2, 3)
    assert seen == [("prefill", (2, 9, tcfg.d_model), torch.bfloat16)] + \
        [("decode", (2, 1, tcfg.d_model), torch.bfloat16)] * 2
    again = tserve.serve(tcfg, batch=2, prompt_len=9, gen=3, device="cpu")
    np.testing.assert_array_equal(run.tokens, again.tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_reduced_config(arch, capsys):
    import json

    tserve.main(["--arch", arch, "--device", "cpu", "--batch", "1", "--prompt-len", "8", "--gen", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == arch and out["device"] == "cpu" and len(out["sample_tokens"]) == 2
