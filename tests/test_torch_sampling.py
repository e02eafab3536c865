"""The port's sampling path against the JAX package, on the CPU in float32.

The uniform field against a numpy ``uint32`` transcription of the TPU
kernels' hash (``decode_step.py:698-714``); ``filter_top_k``,
``filter_top_p`` and ``next_token_probs`` against the JAX filters element by
element; one step of ``sample_tokens`` against ``_sample_next_token``; the
temperature fold against the JAX kernels' in bf16; the plain sampling
decodes (``sample_decode_plain``, ``grid_sample_decode_plain``) against
``pallas_full_sample_decode`` and ``pallas_full_grid_sample_decode`` in
interpret mode, with tiles smaller than the batch, under top-k, top-p, both,
a temperature and early exit; the grid default tile against ``_auto_tile``;
the eager oracle's draws; and ``Predictor.decode_canvases`` with the JAX
package's per-batch seed against the JAX ``Predictor``.

The draws follow the same random stream on both sides, so the float32
tokens are equal.  (Sums in another order could move a draw where the
reference is within a rounding step of a knife edge: ``sample_tokens``
gives those distances, which ``chip_smoke.py`` uses on the card; none is
met at these inputs.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.decoding.decode import DecodeConfig as JaxDecodeConfig
from img2latex_tpu.decoding.decode import _next_token_probs as jax_next_token_probs
from img2latex_tpu.decoding.decode import filter_top_k as jax_filter_top_k
from img2latex_tpu.decoding.decode import filter_top_p as jax_filter_top_p
from img2latex_tpu.models.seq2seq import Seq2SeqModel as JaxSeq2Seq
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.ops.pallas.decode_step import _sample_next_token
from img2latex_tpu.ops.pallas.decode_step import pack_decoder_weights as jax_pack
from img2latex_tpu.ops.pallas.decode_step import pallas_full_sample_decode
from img2latex_tpu.ops.pallas.grid_decode import _auto_tile
from img2latex_tpu.ops.pallas.grid_decode import pack_attention_weights as jax_pack_att
from img2latex_tpu.ops.pallas.grid_decode import pallas_full_grid_sample_decode
from img2latex_tpu.ops.preprocess import normalize_images as jax_normalize
from img2latex_tpu.training.predictor import Predictor as JaxPredictor
from img2latex_tpu_torch.bridge import load_flax_params
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.decoding.decode import (
    DecodeConfig,
    filter_top_k,
    filter_top_p,
    greedy_decode_eager,
    next_token_probs,
    trim_host,
)
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.ops import decode_step as ds
from img2latex_tpu_torch.ops import grid_decode as gd
from img2latex_tpu_torch.training.predictor import Predictor, batch_seed

torch.set_num_threads(1)

H_IMG, W_IMG, E, H, V, T, B, TILE = 16, 64, 32, 48, 150, 12, 20, 8
SETTINGS = [dict(top_k=5), dict(top_p=0.9), dict(top_k=10, top_p=0.8), dict(top_k=4, temperature=0.7),
            dict(top_p=0.6, temperature=1.3), dict(top_k=1)]
# p off the multiples of 1/100: there the masses of _logits' row of 100 equal
# logits land on p exactly, and the sums' rounding decides the nucleus
FILTERS = [dict(top_k=3), dict(top_p=0.705), dict(top_k=5, top_p=0.505, temperature=0.6),
           dict(top_k=500, top_p=0.955, temperature=2.0), dict(top_k=2, temperature=0.5)]


def _field_numpy(seed, t, rows, Vp, tile):
    """The TPU kernels' uniform field, transcribed in numpy uint32."""
    r = np.arange(rows, dtype=np.uint32)[:, None]
    col = np.arange(Vp, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        x = np.uint32(seed % 2**32) + r // np.uint32(tile)
        x = x + np.uint32(t) * np.uint32(0x9E3779B9) + (r % np.uint32(tile)) * np.uint32(0x85EBCA6B)
        x = x + col * np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    u = (x >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    return u * np.float32(1.0 - 2e-7) + np.float32(1e-7)


@pytest.mark.parametrize("seed", [-1, 0, 2**31 - 1, -(2**31), 987654321])
def test_uniform_field_matches_numpy_uint32(seed):
    for t, tile in ((0, 256), (7, 8), (140, 5)):
        got = ds.uniform_field(seed, t, 37, 256, tile)
        assert got.dtype == torch.float32 and tuple(got.shape) == (37, 256)
        np.testing.assert_array_equal(got.numpy(), _field_numpy(seed, t, 37, 256, tile))
    u = ds.uniform_field(seed, 3, 64, 512).numpy()
    assert u.min() > 0 and u.max() < 1 and len(np.unique(u)) > 0.99 * u.size


def _logits(seed, rows=48, cols=100):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, cols)) * 2).astype(np.float32)
    x[0] = 1.0  # a row of equal logits
    x[1, :10] = x[1, 10:20]  # ties across the row
    x[2, 7] = 40.0  # all mass on one token
    return x


@pytest.mark.parametrize("kw", FILTERS)
def test_filters_match_jax(kw):
    x = _logits(len(str(kw)))
    cfg = DecodeConfig(**kw)
    jcfg = JaxDecodeConfig(**kw)
    probs = np.array(jax.nn.softmax(jnp.asarray(x), axis=-1))
    tp = torch.from_numpy(probs)
    if cfg.top_k:
        np.testing.assert_allclose(filter_top_k(tp, cfg.top_k).numpy(),
                                   np.asarray(jax_filter_top_k(jnp.asarray(probs), cfg.top_k)), atol=1e-6)
    if cfg.top_p:
        np.testing.assert_allclose(filter_top_p(tp, cfg.top_p).numpy(),
                                   np.asarray(jax_filter_top_p(jnp.asarray(probs), cfg.top_p)), atol=1e-6)
    got = next_token_probs(torch.from_numpy(x), cfg).numpy()
    ref = np.asarray(jax_next_token_probs(jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert ((got > 0) == (ref > 0)).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert cfg.sampling and not DecodeConfig(top_k=3, temperature=0.0).sampling
    assert not DecodeConfig(temperature=0.5).sampling


def _check_draws(got, ref, gaps, mass_gaps):
    """Equal tokens; the knife-edge distances have the tokens' shape and are
    >= 0 (inf where no edge applies)."""
    got = np.asarray(got)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ref))
    for d in (np.asarray(gaps), np.asarray(mass_gaps)):
        assert d.shape == got.shape and (d >= 0).all()


@pytest.mark.parametrize("kw", FILTERS + [dict(top_k=1), dict(top_p=1.0)])
def test_sample_tokens_matches_jax_step(kw):
    """One step of the filtered draw, at the same logits and uniforms."""
    x = _logits(7 + len(str(kw)), rows=64, cols=256)
    x[:, 200:] = -1e30  # padded columns
    kw = dict(kw)
    t = kw.pop("temperature", 1.0)
    x = (x / np.float32(t)).astype(np.float32)
    top_k, top_p = kw.get("top_k", 0), kw.get("top_p", 0.0)
    u = ds.uniform_field(5, 2, 64, 256)
    col = jax.lax.broadcasted_iota(jnp.int32, (64, 256), 1)
    ref = np.asarray(_sample_next_token(jnp.asarray(x), col, top_k, top_p, jnp.asarray(u.numpy())))[:, 0]
    got, gap, mass_gap = ds.sample_tokens(torch.from_numpy(x), u, top_k, top_p)
    _check_draws(got.numpy(), ref, gap.numpy(), mass_gap.numpy())
    assert (got < 200).all() and got[2] == 7  # never a padded column; all mass on one token
    if top_k == 1:  # the argmax, where it is unique (every tie of the k-th logit stays)
        unique = (x == x.max(-1, keepdims=True)).sum(-1) == 1
        np.testing.assert_array_equal(got.numpy()[unique], x.argmax(-1)[unique])
        assert unique.sum() > 60


def test_fold_temperature_matches_jax_bf16():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(40, 128)).astype(np.float32)
    b = np.where(np.arange(128) < 100, rng.normal(size=128), -1e30).astype(np.float32)
    packed = {"w_out": torch.from_numpy(w).to(torch.bfloat16), "b_out": torch.from_numpy(b)}
    for temp in (0.7, 1.3, 0.05):
        folded = ds.fold_temperature(packed, temp)
        inv = jnp.float32(1.0 / temp)
        ref_w = (jnp.asarray(w, jnp.bfloat16).astype(jnp.float32) * inv).astype(jnp.bfloat16)
        np.testing.assert_array_equal(folded["w_out"].float().numpy(), np.asarray(ref_w.astype(jnp.float32)))
        np.testing.assert_array_equal(folded["b_out"].numpy(), np.asarray(jnp.asarray(b) * inv))
        assert ds.fold_temperature(packed, temp) is folded  # cached per temperature
    assert ds.fold_temperature(packed, 1.0) is packed and ds.fold_temperature(packed, 0.0) is packed


@pytest.fixture(scope="module")
def model():
    """A small grid model (V = 150, so Vp = 256) whose vocab logits are
    scaled up (a sampled decode of random weights is otherwise drawn by the
    noise alone) and whose rows end at different steps; its memories and
    both packages' packed weights."""
    cfg = JaxConfig()
    cfg.model.memory = "grid"
    cfg.model.embedding_dim = E
    cfg.model.decoder.hidden_dim = H
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height = H_IMG
    cfg.model.encoder.cnn.img_width = W_IMG
    cfg.model.encoder.cnn.conv_filters = [4, 8]
    cfg.hardware.compute_dtype = "float32"
    jmodel = jax_build_model(cfg, V)
    params = jax.tree_util.tree_map(np.array, jax.device_get(jmodel.init(
        jax.random.PRNGKey(4), jnp.zeros((2, H_IMG, W_IMG, 1)), jnp.zeros((2, 5), jnp.int32))))
    out = params["params"]["decoder"]["cell"]["out"]
    out["kernel"] *= 4.0
    out["bias"][2] = out["bias"].max() + 0.5  # END: rows end at different steps
    tmodel = load_flax_params(build_model(config_from_dict(cfg.to_dict()), V, device="cpu"), params)
    u8 = np.random.default_rng(1).integers(0, 256, size=(B, H_IMG, W_IMG, 1), dtype=np.uint8)
    jmem = jmodel.apply(params, jax_normalize(jnp.asarray(u8)), method=JaxSeq2Seq.encode)
    tmem = torch.from_numpy(np.array(jmem))
    att = gd.pack_attention_weights(tmodel.decoder, torch.float32)
    return dict(cfg=cfg, params=params, jmem=jmem, tmem=tmem,
                packed=ds.pack_decoder_weights(tmodel.decoder, torch.float32), att=att,
                u=gd.grid_memory_proj(att, tmem), jpacked=jax_pack(params, V, dtype=jnp.float32),
                jatt=jax_pack_att(params, dtype=jnp.float32))


def _decode_pair(m, kind, kw, seed, early_exit=False, batch_tile=TILE):
    kw = dict(kw)
    top_k = kw.pop("top_k", 0)
    if kind == "grid":
        ref = pallas_full_grid_sample_decode(m["jpacked"], m["jatt"], m["jmem"], T, 1, 2, 0, top_k, seed,
                                             interpret=True, batch_tile=batch_tile, early_exit=early_exit,
                                             **kw)
        got = gd.grid_sample_decode_plain(m["packed"], m["att"], m["tmem"], m["u"], T, 1, 2, 0, top_k, seed,
                                          batch_tile=batch_tile, early_exit=early_exit, return_gaps=True,
                                          **kw)
    else:
        ref = pallas_full_sample_decode(m["jpacked"], m["jmem"][:, 0, :], T, 1, 2, 0, top_k, seed,
                                        interpret=True, batch_tile=batch_tile, early_exit=early_exit, **kw)
        got = ds.sample_decode_plain(m["packed"], m["tmem"][:, 0, :], T, 1, 2, 0, top_k, seed,
                                     batch_tile=batch_tile, early_exit=early_exit, return_gaps=True, **kw)
    return np.asarray(ref), tuple(x.numpy() for x in got)


@pytest.mark.parametrize("kind", ["vector", "grid"])
@pytest.mark.parametrize("kw", SETTINGS)
def test_plain_decode_matches_pallas_kernel(model, kind, kw):
    """Three tiles of 8 rows (the last ragged), seed 2^31 - 2: the second
    tile's seed wraps to -2^31."""
    ref, (got, gaps, mass_gaps) = _decode_pair(model, kind, kw, 2**31 - 2)
    _check_draws(got, ref, gaps, mass_gaps)
    assert len(np.unique(ref)) > (1 if kw == dict(top_k=1) else 3)
    wrapper = (gd.grid_sample_decode(model["packed"], model["att"], model["tmem"], model["u"], T, 1, 2, 0,
                                     kw.get("top_k", 0), 2**31 - 2, temperature=kw.get("temperature", 1.0),
                                     top_p=kw.get("top_p", 0.0), batch_tile=TILE)
               if kind == "grid" else
               ds.sample_decode(model["packed"], model["tmem"][:, 0, :], T, 1, 2, 0, kw.get("top_k", 0),
                                2**31 - 2, temperature=kw.get("temperature", 1.0), top_p=kw.get("top_p", 0.0),
                                batch_tile=TILE))
    np.testing.assert_array_equal(wrapper.numpy(), got)


@pytest.mark.parametrize("kind", ["vector", "grid"])
def test_early_exit_and_default_tile_match_pallas_kernel(model, kind):
    """Early exit gives the full loop's tokens and the JAX kernel's; the
    default tile (256 for vector memory, ``_auto_tile`` for grid) too."""
    kw = dict(top_k=10, top_p=0.8, temperature=0.8)
    ref, (got, gaps, mass_gaps) = _decode_pair(model, kind, kw, 11, early_exit=True)
    _check_draws(got, ref, gaps, mass_gaps)
    full = _decode_pair(model, kind, kw, 11)[1][0]
    np.testing.assert_array_equal(got, full)
    ends = (full == 2).argmax(axis=1)[(full == 2).any(axis=1)]
    assert len(ends) > B // 2 and len(set(ends.tolist())) > 2  # rows end, at different steps
    default = ds.BATCH_TILE if kind == "vector" else 0
    ref, (got, gaps, mass_gaps) = _decode_pair(model, kind, kw, -5, batch_tile=default)
    _check_draws(got, ref, gaps, mass_gaps)
    assert (ref != _decode_pair(model, kind, kw, -4, batch_tile=default)[0]).any()  # the seed matters


def test_decode_raises_without_a_filter(model):
    with pytest.raises(ValueError):
        ds.sample_decode(model["packed"], model["tmem"][:, 0, :], T, 1, 2, 0, 0, 1, top_p=0.0)


def _jax_zeros(shapes, dtype):
    return {k: jnp.zeros(s, dtype) for k, s in shapes.items()}


@pytest.mark.parametrize("dims", [(2, 512, 256, 384, 384, 100, "bf16"), (2, 32, 16, 48, 48, 16, "f32"),
                                  (3, 1024, 512, 1024, 512, 300, "bf16")])
def test_auto_tile_matches_jax(dims):
    """At the grid flagship's width (Vp = 512, E = 256, A = H = 384, S =
    100, bf16) the tile of a batch of 512 is 128."""
    L, Vp, Em, H_, A, S, dt = dims
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dt == "bf16" else (jnp.float32, torch.float32)
    shapes = {"emb": (Vp, Em), "w_out": (H_, Vp)}
    for i in range(L):
        shapes[f"w_ih_{i}"] = ((2 * Em if i == 0 else H_), 4 * H_)
        shapes[f"w_hh_{i}"] = (H_, 4 * H_)
    f32 = {"b_out": (Vp,), **{f"b_{i}": (4 * H_,) for i in range(L)}}
    meta = {"num_layers": L, "vocab_padded": Vp, "vocab": Vp - 9, "embed_dim": Em, "hidden_dim": H_}
    jp = {**_jax_zeros(shapes, jdt), **_jax_zeros(f32, jnp.float32), **meta}
    tp = {**{k: torch.zeros(s, dtype=tdt) for k, s in shapes.items()},
          **{k: torch.zeros(s) for k, s in f32.items()}, **meta}
    att_shapes = {"w_h": (H_, A), "w_m": (Em, A)}
    att_meta = {"attn_dim": A, "mem_dim": Em, "hidden_dim": H_}
    jatt = {**_jax_zeros(att_shapes, jdt), "b": jnp.zeros((A,)), "v": jnp.zeros((1, A), jdt), **att_meta}
    tatt = {**{k: torch.zeros(s, dtype=tdt) for k, s in att_shapes.items()}, "b": torch.zeros(A),
            "v": torch.zeros(A, dtype=tdt), **att_meta}
    for batch in (0, 1, 7, 20, 100, 300, 512, 2048):
        assert gd.auto_tile(tp, tatt, S, batch=batch) == _auto_tile(jp, jatt, S, batch=batch), batch
    if dims[0] == 2 and Vp == 512:
        assert gd.auto_tile(tp, tatt, S, batch=512) == 128


def test_eager_sampling_draws_from_next_token_probs():
    """The eager oracle's draws at one step: only inside the support of
    ``next_token_probs``, with its frequencies (chi-square p >= 1e-3), and
    reproducible with a seeded generator."""
    rng = np.random.default_rng(9)
    base = torch.from_numpy((rng.normal(size=60) * 1.5).astype(np.float32))
    n = 6000
    cfg = DecodeConfig(max_length=1, end_id=-1, top_k=20, top_p=0.8, temperature=0.9)

    def step_fn(tokens, carry):
        return base.expand(tokens.shape[0], -1), carry

    carry0 = (torch.zeros(1, n, 4), torch.zeros(1, n, 4))
    toks = greedy_decode_eager(step_fn, carry0, n, cfg, generator=torch.Generator().manual_seed(3))[:, 0]
    probs = next_token_probs(base[None], cfg)[0].double()
    support = probs > 0
    counts = torch.bincount(toks.long(), minlength=60).double()
    assert counts[~support].sum() == 0 and 1 < int(support.sum()) < 20
    expected = probs[support] / probs[support].sum() * n
    chi = stats.chisquare(counts[support].numpy(), expected.numpy())
    assert chi.pvalue >= 1e-3, chi
    again = greedy_decode_eager(step_fn, carry0, n, cfg, generator=torch.Generator().manual_seed(3))[:, 0]
    assert torch.equal(toks, again)


def _sampling_pair(memory):
    """The JAX and port Predictors on one small model (``interpret``-mode
    kernels on the JAX side), its vocab weights changed as in ``model``."""
    cfg = JaxConfig()
    cfg.model.memory = memory
    cfg.model.embedding_dim = 32
    cfg.model.decoder.hidden_dim = 32
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height = 16
    cfg.model.encoder.cnn.img_width = 64
    cfg.model.encoder.cnn.conv_filters = [4, 8, 8]
    cfg.data.max_seq_length = 24
    cfg.inference.max_length = 12
    cfg.hardware.compute_dtype = "float32"
    cfg.hardware.use_mesh = False
    cfg.hardware.pallas_interpret = True
    jtok = JaxTokenizer(max_sequence_length=24)
    jtok.default_init()
    jmodel = jax_build_model(cfg, jtok.vocab_size)
    variables = jax.tree_util.tree_map(np.array, jax.device_get(
        jmodel.init(jax.random.PRNGKey(6), jnp.zeros((2, 16, 64, 1)), jnp.zeros((2, 5), jnp.int32))))
    out = variables["params"]["decoder"]["cell"]["out"]
    out["kernel"] *= 4.0
    out["bias"][2] = out["bias"].max() + 0.5  # END
    jpred = JaxPredictor(cfg, jmodel, variables["params"], {}, jtok, batch_size=4)
    tcfg = config_from_dict(cfg.to_dict())
    tok = LaTeXTokenizer.from_config(jtok.to_config())
    tpred = Predictor(tcfg, load_flax_params(build_model(tcfg, tok.vocab_size, device="cpu"), variables),
                      tok, batch_size=4, device="cpu")
    return jpred, tpred


def _jax_batch_seeds(seed, n):
    """The JAX Predictor's kernel seed of each batch (``predictor.py:96``,
    ``decoding/decode.py:556``)."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(int(jax.random.bits(sub, dtype=jnp.uint32).astype(jnp.int32)))
    return out


@pytest.mark.parametrize("memory", ["vector", "grid"])
def test_predictor_matches_jax_with_jax_seeds(memory):
    jpred, tpred = _sampling_pair(memory)
    rng = np.random.default_rng(12)
    canv = rng.integers(0, 256, size=(7, 16, 64, 1), dtype=np.uint8)
    imgs = list(canv)
    for kw in (dict(top_k=5), dict(top_p=0.9, temperature=0.7), dict(top_k=8, top_p=0.8, early_exit=True)):
        ref = jpred.predict_batch(imgs, return_ids=True, seed=21, **kw)
        dcfg = tpred.decode_config(**kw)
        assert dcfg.sampling
        got = []
        for i, s in enumerate(_jax_batch_seeds(21, 2)):
            buf = np.zeros((4, 16, 64, 1), np.uint8)
            chunk = canv[4 * i : 4 * i + 4]
            buf[: len(chunk)] = chunk
            got += trim_host(tpred.decode_canvases(buf, dcfg=dcfg, seed=s)[: len(chunk)], 2, 0, start_id=1)
        assert got == ref, kw
        assert len({len(r) for r in ref}) > 1 and len({t for r in ref for t in r}) > 5


def test_predictor_seeds_batches_with_seed_sequence():
    _, tpred = _sampling_pair("vector")
    imgs = list(np.random.default_rng(13).integers(0, 256, size=(6, 16, 64, 1), dtype=np.uint8))
    kw = dict(top_k=6, temperature=0.9, return_ids=True)
    a = tpred.predict_batch(imgs, seed=5, **kw)
    assert a == tpred.predict_batch(imgs, seed=5, **kw) and a != tpred.predict_batch(imgs, seed=6, **kw)
    dcfg = tpred.decode_config(top_k=6, temperature=0.9)
    buf = np.zeros((4, 16, 64, 1), np.uint8)
    buf[:2] = np.stack(imgs[4:])
    toks = tpred.decode_canvases(buf, dcfg=dcfg, seed=batch_seed(5, 1))[:2]
    assert trim_host(toks, 2, 0, start_id=1) == a[4:]
    s = batch_seed(5, 1)
    assert -(2**31) <= s < 2**31 and s == batch_seed(5, 1) != batch_seed(5, 0)
