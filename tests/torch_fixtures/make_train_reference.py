"""Write ``train_hymba_2l_reference.json``: the JAX package's training
path (``make_train_step``: ``Model.loss`` with ``impl="blockwise"``,
``jax.value_and_grad``, AdamW) on hymba-1.5b, ``launch/train.py``'s
default arch, at full width and 2 layers, op by op on the CPU
(``jax.disable_jit()``: compiled, XLA:CPU keeps bf16 intermediates in f32,
which moves the gradient norm of the smoke config by 2%).

Everything is ``launch/train.py``'s for ``--steps 4``: ``SyntheticLM``
batches of B 8 x S 256 (steps 0-3), ``xent_chunk=128``, AdamW with the
cosine schedule (peak 3e-3, warm-up ``max(4 // 20, 5)``), one microbatch;
the weights are ``carry.numpy_params(cfg, seed=0)``, shared by both
packages.  It records per step ``loss``, ``gnorm`` and ``lr``, and after
the last step for every parameter leaf the mean |p - p0| and the values at
``SAMPLE`` flat indices drawn from ``np.random.default_rng(SAMPLE_SEED)``
(the same for every leaf of a size), and the mean |m| and mean v of the
optimizer's moments.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_train_reference.py

Takes ~10 minutes and ~10 GB of host memory.
"""
import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models.model import Model
from repro.train.loop import TrainConfig, make_train_step
from repro.train.optimizer import AdamW, cosine_schedule
from repro_torch import carry
from repro_torch.configs.base import get_config as port_config
from repro_torch.models import transformer as tf

OUT = pathlib.Path(__file__).parent / "train_hymba_2l_reference.json"
ARCH, LAYERS, SEED = "hymba-1.5b", 2, 0
STEPS, BATCH, SEQ, LR = 4, 8, 256, 3e-3
SAMPLE, SAMPLE_SEED = 512, 7


def sample_index(size: int) -> np.ndarray:
    """The flat indices a leaf of ``size`` entries is sampled at."""
    return np.random.default_rng([SAMPLE_SEED, size]).integers(
        0, size, min(SAMPLE, size))


def main() -> None:
    t0 = time.perf_counter()
    cfg = get_config(ARCH).scaled(n_layers=LAYERS)
    params = carry.numpy_params(
        port_config(ARCH).scaled(n_layers=LAYERS), SEED,
        leaf_fn=lambda name, a: jnp.asarray(
            a, jnp.float32 if tf.is_f32_leaf(name) else jnp.bfloat16))
    p0 = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
          for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    model = Model(cfg, xent_chunk=128)          # impl="blockwise"
    opt = AdamW(lr=cosine_schedule(LR, warmup=max(STEPS // 20, 5),
                                   total=STEPS))
    step_fn = make_train_step(model, opt, TrainConfig(microbatches=1))
    state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH))
    steps = []
    with jax.disable_jit():
        for i in range(STEPS):
            b = data.batch(i)
            params, state, m = step_fn(
                params, state, {k: jnp.asarray(v) for k, v in b.items()})
            steps.append({k: float(v) for k, v in m.items()}
                         | {"tokens_sum": int(b["tokens"].sum())})
            print(f"step {i} {steps[-1]} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    leaves = {}
    flat_m = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(state.m)[0]}
    flat_v = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(state.v)[0]}
    for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax.tree_util.keystr(k)
        p = np.asarray(v, np.float32)
        idx = sample_index(p.size)
        leaves[name] = {
            "mean_abs_delta": float(np.abs(p - p0[name]).mean()),
            "sample": p.reshape(-1)[idx].tolist(),
            "m_mean_abs": float(np.abs(flat_m[name]).mean()),
            "v_mean": float(flat_v[name].mean())}
    rec = {"arch": ARCH, "n_layers": LAYERS, "weights_seed": SEED,
           "steps": STEPS, "batch": BATCH, "seq": SEQ, "lr": LR,
           "xent_chunk": 128, "impl": "blockwise", "op_by_op": True,
           "sample": SAMPLE, "sample_seed": SAMPLE_SEED,
           "jax": jax.__version__, "metrics": steps, "leaves": leaves}
    OUT.write_text(json.dumps(rec) + "\n")
    print(f"wrote {OUT} ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
