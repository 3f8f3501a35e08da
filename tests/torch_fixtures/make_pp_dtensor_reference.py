"""Write ``pp_dtensor_reference.npz``: the JAX package's pipeline
(``repro/train/pipeline.py::make_pp_loss``) compiled on a (2, 2)
("data", "model") mesh of four host devices, with its parameters and
batch placed as the reference's dry run places them under ``--pp``
(``repro/launch/dryrun.py::build_step``: the stacked layers sharded on
"model", "model" dropped from their other dims, FSDP and the batch on
"data").  It is what ``tests/test_torch_pipeline_dtensor.py`` holds the
port's DTensor path of the pipeline (the dry run's ``--pp``) against.

For granite-8b's and hymba-1.5b's ``.smoke()`` configs (2 layers: 2
stages of one layer, 2 microbatches, ``remat="none"``,
``xent_chunk=16``), on the weights ``carry.numpy_params(cfg, 0)`` and a
4 x 32 batch drawn from ``SEED``, it records the batch, the loss and
every gradient (``jax.value_and_grad``, compiled), under
``<arch>/tokens``, ``<arch>/labels``, ``<arch>/loss`` and
``<arch>/grad<leaf>`` (bf16 values as their f32 widening; ``<leaf>`` is
``jax.tree_util.keystr`` of the leaf's path).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_pp_dtensor_reference.py

Takes ~30 s (it sets ``XLA_FLAGS`` for 4 host devices itself, before JAX
is imported).
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import pathlib  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import ShapeSpec, get_config  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.model import Model  # noqa: E402
from repro.sharding import specs as sh  # noqa: E402
from repro.train.pipeline import make_pp_loss  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs.base import get_config as port_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

OUT = pathlib.Path(__file__).parent / "pp_dtensor_reference.npz"
ARCHS = ("granite-8b", "hymba-1.5b")
SEED, BATCH, SEQ = 5, 4, 32
STAGES, MICRO, XENT_CHUNK = 2, 2, 16


def pp_specs(cfg, model, mesh, inputs):
    """The reference dry run's ``--pp`` placement of the parameters and
    the batch."""
    pps = dict(sh.param_pspecs(cfg, model.param_specs(), mesh))

    def strip_model(spec):
        tail = [None if a == "model" else a for a in tuple(spec)[1:]]
        return P("model", *tail)
    pps["layers"] = jax.tree.map(strip_model, pps["layers"],
                                 is_leaf=lambda v: isinstance(v, P))
    return sh.named(pps, mesh), sh.named(sh.batch_pspecs(inputs, mesh),
                                         mesh)


def main() -> None:
    t0 = time.perf_counter()
    assert len(jax.devices()) >= 4, jax.devices()
    mesh = make_mesh((2, 2), ("data", "model"))
    rng = np.random.default_rng(SEED)
    arrays = {}
    for arch in ARCHS:
        cfg = get_config(arch).smoke()
        params = carry.numpy_params(
            port_config(arch).smoke(), 0,
            leaf_fn=lambda name, a: jnp.asarray(
                a, jnp.float32 if tf.is_f32_leaf(name) else jnp.bfloat16))
        toks = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        labs = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
        inputs = Model(cfg).input_specs(ShapeSpec("t", SEQ, BATCH, "train"))
        p_sh, b_sh = pp_specs(cfg, Model(cfg), mesh, inputs)
        loss_fn = make_pp_loss(cfg, mesh, n_stages=STAGES, n_micro=MICRO,
                               remat="none", xent_chunk=XENT_CHUNK)
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(loss_fn),
                                  in_shardings=(p_sh, b_sh))(params, batch)
        arrays[f"{arch}/tokens"] = toks
        arrays[f"{arch}/labels"] = labs
        arrays[f"{arch}/loss"] = np.float32(loss)
        for k, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            arrays[f"{arch}/grad{jax.tree_util.keystr(k)}"] = np.asarray(
                jnp.asarray(g).astype(jnp.float32))
        print(f"{arch}: loss {float(loss)} ({time.perf_counter() - t0:.1f} "
              "s)", flush=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, "
          f"{time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
