"""The port covers the JAX package's public API: a check by ``ast``.

Both trees are parsed, neither package is imported.  Four things must
hold, each but for the entries of ``ALLOWED``:

- every module of ``src/repro/`` has a module at the same path in
  ``src/repro_torch/``;
- every public top-level name of a module (functions, classes, module
  constants; what a package's ``__init__.py`` imports) has one of the
  same name in its counterpart;
- every public method of a class has one in the counterpart's class;
- every parameter of a public function or method (``*args`` and
  ``**kwargs`` by name) has one in its counterpart.

``ALLOWED`` holds the deliberate differences.  Each entry gives why, where
the port does the same job (``None``: the reference itself never uses
the name), and the test that holds that; an entry that no longer names a
difference fails, so the list cannot outlive what it excuses.
"""
import ast
import functools
import pathlib

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

_PALLAS = ("a Pallas launch parameter (tile size or interpret mode)",
           "the CUDA kernels choose their tiles in "
           "src/repro_torch/kernels/csrc/; on a CPU tensor the wrapper runs "
           "the kernel's plain version",
           "tests/test_torch_flash.py, tests/test_torch_rmsnorm.py, "
           "tests/test_torch_ssd.py")
_KEY = ("a JAX PRNG key",
        "a torch.Generator (``generator``), drawn from in the reference's "
        "order and distributions",
        "tests/test_torch_model.py")
_SPEC = ("a PartitionSpec helper or argument for GSPMD",
         "DTensor placements from src/repro_torch/sharding/specs.py "
         "(param_pspecs, cache_pspecs, batch_pspecs, constrain)",
         "tests/test_torch_sharding.py, tests/test_torch_dryrun.py")
_DEVICES = ("``pmap`` over host devices",
            "one card: all lanes in one lockstep batch; a mesh over the "
            "ranks of the process group (``device`` names the type)",
            "tests/test_torch_sweep.py, tests/test_torch_sharding.py")
_UNUSED = ("defined but never used by the reference", None,
           "tests/test_torch_api_parity.py::test_unused_names_have_no_caller")

# "module:name" for a top-level name or method ("module:Class.method"),
# "module:function(param)" for a parameter
ALLOWED = {
    **{k: _PALLAS for k in (
        "kernels/flash_attention.py:flash_attention_bhsd(bq)",
        "kernels/flash_attention.py:flash_attention_bhsd(bkv)",
        "kernels/flash_attention.py:flash_attention_bhsd(interpret)",
        "kernels/ops.py:flash_attention(interpret)",
        "kernels/ops.py:rmsnorm(interpret)",
        "kernels/ops.py:ssd(interpret)",
        "kernels/rmsnorm.py:rmsnorm_2d(block_rows)",
        "kernels/rmsnorm.py:rmsnorm_2d(interpret)",
        "kernels/ssd_scan.py:ssd_intra_chunk(interpret)")},
    "kernels/flash_attention.py:NEG": (
        "the Pallas kernel body's mask value",
        "the plain version masks with -1e30 (kernels/ref.py), the CUDA "
        "kernels with their own", "tests/test_torch_flash.py"),
    **{k: _KEY for k in (
        "models/model.py:Model.init(key)",
        "models/model.py:Model.make_inputs(key)",
        "models/transformer.py:init_params(key)",
        "serve/sampler.py:sample(key)")},
    **{k: _SPEC for k in (
        "models/attention.py:attn_spec",
        "models/layers.py:constrain",
        "models/layers.py:mlp_spec",
        "models/layers.py:norm_spec",
        "models/moe.py:moe_spec",
        "models/ssm.py:ssm_spec",
        "models/ssm.py:ssm_state_spec",
        "models/transformer.py:layer_spec",
        "models/transformer.py:encoder(act_spec)",
        "models/transformer.py:lm_loss(act_spec)",
        "models/transformer.py:lm_loss(sp_specs)",
        "models/transformer.py:lm_loss(moe_specs)",
        "models/transformer.py:lm_loss(fsdp_gather_specs)")},
    "train/grad_compress.py:compressed_psum(axis_name)": (
        "the name of a ``shard_map`` axis",
        "the port's compressed_psum takes the DeviceMesh and its axes "
        "(``mesh``, ``axes``)", "tests/test_torch_grad_compress.py"),
    **{k: _DEVICES for k in (
        "core/simulator.py:run_batch(devices)",
        "core/sweep.py:run_sweep_batched(devices)",
        "launch/mesh.py:make_mesh(devices)")},
    "core/simulator.py:init_state_batch": (
        "a broadcast of init_state over lanes",
        "init_state(..., lanes=G), which run_batch calls",
        "tests/test_torch_simulator.py"),
    "models/transformer.py:Params": (
        "a type alias (``Any``) for annotations",
        "the port annotates parameter trees as ``dict``",
        "tests/test_torch_model.py"),
    "models/layers.py:sinusoidal_positions": _UNUSED,
    "models/layers.py:norm_init": _UNUSED,
}


def _modules(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): p for p in sorted(
        root.rglob("*.py"))}


def _params(f: ast.FunctionDef) -> list:
    a = f.args
    out = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    out += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return out


def _top_level(body):
    """Statements at module level, into top-level ``if``/``try`` blocks."""
    for n in body:
        if isinstance(n, ast.If):
            yield from _top_level(n.body + n.orelse)
        elif isinstance(n, ast.Try):
            yield from _top_level(n.body + n.orelse + n.finalbody
                                  + [s for h in n.handlers for s in h.body])
        else:
            yield n


def _targets(t):
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _targets(e)


def api(path: pathlib.Path) -> dict:
    """Public top-level names -> ``None`` (a constant or re-export), the
    parameter list of a function, or ``{method: parameters}`` of a
    class."""
    tree = ast.parse(path.read_text(), str(path))
    out = {}
    for n in _top_level(tree.body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[n.name] = _params(n)
        elif isinstance(n, ast.ClassDef):
            out[n.name] = {m.name: _params(m) for m in n.body if isinstance(
                m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(n, ast.Assign):
            out.update({k: None for t in n.targets for k in _targets(t)})
        elif isinstance(n, ast.AnnAssign):
            out.update({k: None for k in _targets(n.target)})
        elif isinstance(n, (ast.Import, ast.ImportFrom)) \
                and path.name == "__init__.py":
            out.update({(a.asname or a.name).split(".")[0]: None
                        for a in n.names})
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _pairs():
    ref, port = _modules(REF), _modules(PORT)
    for m in ref:
        if m in port:
            yield m, api(ref[m]), api(port[m])


@functools.lru_cache(maxsize=None)
def _missing() -> dict:
    """Every difference, keyed as in ``ALLOWED``, by the rule it breaks."""
    out = {"module": [], "name": [], "method": [], "param": []}
    port = _modules(PORT)
    out["module"] = [m for m in _modules(REF) if m not in port]
    for m, ra, pa in _pairs():
        for name, r in ra.items():
            if name not in pa:
                out["name"].append(f"{m}:{name}")
                continue
            p = pa[name]
            if isinstance(r, dict) and isinstance(p, dict):
                for meth, rp in r.items():
                    if meth.startswith("_"):
                        continue
                    if meth not in p:
                        out["method"].append(f"{m}:{name}.{meth}")
                        continue
                    out["param"] += [f"{m}:{name}.{meth}({a})" for a in rp
                                     if a not in p[meth]]
            elif isinstance(r, list) and isinstance(p, list):
                out["param"] += [f"{m}:{name}({a})" for a in r if a not in p]
    return out


def _unexcused(rule: str) -> list:
    """Differences under ``rule`` that ``ALLOWED`` does not excuse."""
    return [k for k in _missing()[rule] if k not in ALLOWED]


def test_every_module_has_a_counterpart():
    assert len(_modules(REF)) > 50
    assert _unexcused("module") == []


def test_every_public_name_has_a_counterpart():
    assert _unexcused("name") == []


def test_every_public_method_has_a_counterpart():
    assert _unexcused("method") == []


def test_every_parameter_has_a_counterpart():
    assert _unexcused("param") == []


def test_allowed_entries_are_live_and_explained():
    """Every entry names a difference that exists and gives its reason,
    the port's way (or that the reference never uses it) and a test file
    that exists; the execution chunk, the sweep's driver and the points
    counter are not excused."""
    found = {k for keys in _missing().values() for k in keys}
    assert sorted(set(ALLOWED) - found) == []
    for key, (why, port, tests) in ALLOWED.items():
        assert why and tests and (port is None) == (ALLOWED[key] is _UNUSED)
        for t in tests.split(", "):
            assert (SRC.parent / t.split("::")[0]).is_file(), (key, t)
    for k in ALLOWED:
        assert "(chunk)" not in k and "(driver)" not in k
        assert not k.endswith(":POINTS_RUN")


def test_unused_names_have_no_caller():
    """The names excused as unused are read nowhere in ``src/repro/``
    (an import of one, as in ``transformer.py``, is no use)."""
    unused = {k.split(":")[1] for k, v in ALLOWED.items() if v is _UNUSED}
    used = set()
    for p in _modules(REF).values():
        for n in ast.walk(ast.parse(p.read_text())):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                used.add(n.id)
            elif isinstance(n, ast.Attribute):
                used.add(n.attr)
    assert unused and unused.isdisjoint(used)
