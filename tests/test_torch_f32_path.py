"""The f32 path to the CUDA-core kernels, against the JAX package.

``Model(cfg, param_dtype=float32, impl="pallas")`` runs the reference's
Pallas kernels in f32: bf16 activations meet f32 weights, ``jnp``'s ``@``
promotes them, and attention and the SSD block see f32 inputs.  In the port
those inputs take the CUDA-core routes (``csrc/flash_attention.cu``,
``csrc/ssd_scan.cu``); here, on the CPU, each wrapper runs its plain
version, so the test holds the port's model path (the promotion in
``layers.dot``, the routes, the arguments each kernel is called with)
against the reference's, at hymba-1.5b's width and 2 layers:

- every call on the path is recorded: 2 to flash attention (f32, hd 64,
  hymba's window of 2048) and 2 to the SSD block (f32, P 50, N 16, B and C
  read by group, ``heads=64``, scores not rounded), each on the CUDA-core
  route;
- the forward's logits against the reference's with ``impl="pallas"``
  (Pallas in interpret mode, op by op under ``jax.disable_jit()``) to
  2^-8 of the largest reference logit, and ``Model.loss`` to rel 1e-4.
  The logits differ by 1.33e-3 of the largest, for ``impl="naive"`` and
  ``"pallas"`` alike (2.86e-3 while the port's SSD took its within-chunk
  prefix sums with ``torch.cumsum``, which accumulates in double on the
  CPU where XLA adds f32 in blocks of 16; ``ref.xla_cumsum`` adds in
  XLA's order).  What remains is the order of the f32 matmuls' sums,
  which the reference's bf16 casts (the embedding entering the layers,
  the SSD's chunk states, the SSM's output and gated norm) turn into
  one-ulp flips, grown by two random-weight layers;
  ``tests/test_torch_ssm_stages.py`` holds each stage of the SSM.  2^-8
  is the smallest power of two at or above 1.5x that.  Within each
  package ``pallas`` equals ``naive`` to 7e-6;
- ``impl="pallas"`` against ``impl="naive"`` in the port to 1e-4 of the
  largest logit, the check ``chip_smoke.py`` and
  ``tests/test_torch_cuda.py`` make on the card (on the CPU both run the
  plain versions: equal).

Weights are ``carry.numpy_params(rounded=False)``: f32 leaves, given
unchanged to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

NAME = "hymba-1.5b"
S = 256                    # two SSM chunks of 128
JAX_ATOL = 2.0 ** -8       # of the largest reference logit (1.33e-3)
LOSS_RTOL = 1e-4
KERNEL_ATOL = 1e-4         # pallas vs naive, of the largest logit


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = base.get_config(NAME).scaled(n_layers=2, vocab=4096)
    jcfg = jbase.get_config(NAME).scaled(n_layers=2, vocab=4096)
    tree = carry.numpy_params(cfg, 0, rounded=False)
    tp = _tree(tree, lambda a: torch.from_numpy(np.asarray(a, np.float32)))
    jp = _tree(tree, lambda a: jnp.asarray(a, jnp.float32))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (1, S)).astype(np.int32)
    return cfg, jcfg, tp, jp, toks


def _port_logits(cfg, tp, toks, impl):
    with torch.no_grad():
        return tf.lm_logits(cfg, tp, tf.lm_hidden(
            cfg, tp, torch.from_numpy(toks), impl=impl)).float().numpy()[
            ..., :cfg.vocab]


def _jax_logits(jcfg, jp, toks, impl):
    with jax.disable_jit():
        x = jp["embed"][jnp.asarray(toks)].astype(jnp.bfloat16)
        x = jtf.backbone(jcfg, jp, x, positions=jnp.arange(toks.shape[1]),
                         causal=True, impl=impl)
        h = jlayers.norm(x, jp["ln_f"], jcfg.norm)
        return np.asarray(jnp.einsum("bsd,vd->bsv", h, jp["embed"])
                          .astype(jnp.float32))[..., :jcfg.vocab]


def test_f32_forward_calls_the_cuda_core_routes(setup, monkeypatch):
    cfg, _, tp, _, toks = setup
    assert tp["embed"].dtype == torch.float32
    calls = []
    real_fa, real_ssd = flash_attention.flash_attention_bhsd, \
        ssd_scan.ssd_intra_chunk

    def fa(q, k, v, **kw):
        calls.append(("flash", flash_attention.route(q.dtype, q.shape[-1]),
                      q.dtype, q.shape[-1], kw["window"]))
        return real_fa(q, k, v, **kw)

    def ssd(x, dt, A, B, C, **kw):
        ts = (x, dt, A, B, C)
        calls.append(("ssd", ssd_scan.route(tuple(t.dtype for t in ts),
                                            *x.shape[2:], B.shape[-1]),
                      tuple(t.dtype for t in ts), x.shape[-1], B.shape[-1],
                      B.shape[0], kw["heads"], kw["round_scores"]))
        return real_ssd(x, dt, A, B, C, **kw)

    monkeypatch.setattr(flash_attention, "flash_attention_bhsd", fa)
    monkeypatch.setattr(ssd_scan, "ssd_intra_chunk", ssd)
    _port_logits(cfg, tp, toks, "pallas")
    f32 = torch.float32
    assert calls == [("flash", "cuda_core", f32, 64, 2048),
                     ("ssd", "cuda_core", (f32,) * 5, 50, 16, 1, 64, False)
                     ] * 2


def test_f32_forward_matches_jax(setup):
    cfg, jcfg, tp, jp, toks = setup
    want = _jax_logits(jcfg, jp, toks, "pallas")
    got = _port_logits(cfg, tp, toks, "pallas")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=JAX_ATOL * np.abs(want).max())


def test_f32_loss_matches_jax(setup):
    cfg, jcfg, tp, jp, toks = setup
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    with jax.disable_jit():
        want = float(JModel(jcfg, impl="pallas", param_dtype=jnp.float32)
                     .loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(Model(cfg, impl="pallas", param_dtype=torch.float32).loss(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()}))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_f32_pallas_matches_naive(setup):
    cfg, _, tp, _, toks = setup
    naive = _port_logits(cfg, tp, toks, "naive")
    np.testing.assert_allclose(_port_logits(cfg, tp, toks, "pallas"), naive,
                               rtol=0, atol=KERNEL_ATOL * np.abs(naive).max())
