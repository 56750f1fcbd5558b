"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package (nor, in the
training slice, ``ml_dtypes``). Its public
surfaces mirror the reference's, read from the reference's source (the
flash-attention package, the scan engine's ``__all__`` and its monoid
registry), and the reference tests' uses of the registry run on the
port."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import repro\b|from repro[. ])", re.M)


# The modules of the relational path (segmented and mask-compact scans,
# the relational operators): each must be found by the import sweep below
# and be free of JAX and the reference on its own.
RELATIONAL_MODULES = (
    "repro_torch.core.scan.segmented",
    "repro_torch.kernels.compact",
    "repro_torch.kernels.compact.ops",
    "repro_torch.kernels.segscan",
    "repro_torch.kernels.segscan.ops",
    "repro_torch.kernels.segscan.ref",
    "repro_torch.relational",
    "repro_torch.relational.compact",
    "repro_torch.relational.groupby",
    "repro_torch.relational.join",
    "repro_torch.relational.partition",
    "repro_torch.relational.sort",
)


# The modules of the affine slice (the SSM scan and the engine pieces it
# added): each must be found by the import sweep and be free of JAX and
# the reference on its own.
AFFINE_MODULES = (
    "repro_torch.kernels.scan_engine.layouts",
    "repro_torch.kernels.scan_engine.cuda",
    "repro_torch.kernels.ssm_scan",
    "repro_torch.kernels.ssm_scan.ops",
    "repro_torch.kernels.ssm_scan.ref",
)


# The modules of the attention slice (the flash attention package and the
# engine's fold pieces): each must be found by the import sweep and be
# free of JAX and the reference on its own.
ATTENTION_MODULES = (
    "repro_torch.core.scan.assoc",
    "repro_torch.core.scan.policy",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.flash_attention",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.scan_engine.cuda_fold",
    "repro_torch.kernels.scan_engine.layouts",
    "repro_torch.kernels.scan_engine.schedules",
)


# The modules of the scan core's vertical and tree oracles and of the
# model configurations: each must be found by the import sweep and be
# free of JAX and the reference on its own.
CORE_CONFIG_MODULES = (
    "repro_torch.core.scan",
    "repro_torch.core.scan.api",
    "repro_torch.core.scan.tree",
    "repro_torch.core.scan.vertical",
    "repro_torch.configs",
    "repro_torch.configs.shapes",
    "repro_torch.configs.gemma3_12b",
    "repro_torch.configs.gemma2_9b",
    "repro_torch.configs.phi3_medium_14b",
    "repro_torch.configs.stablelm_12b",
    "repro_torch.configs.granite_moe_1b_a400m",
    "repro_torch.configs.qwen3_moe_235b_a22b",
    "repro_torch.configs.xlstm_125m",
    "repro_torch.configs.zamba2_7b",
    "repro_torch.configs.llava_next_mistral_7b",
    "repro_torch.configs.seamless_m4t_large_v2",
    "repro_torch.models.config",
)


# The modules of the models slice (the single-device sharding surface, the
# layers, blocks, LM and weight bridge, and the paged KV cache): each must
# be found by the import sweep and be free of JAX and the reference on its
# own.
MODEL_SERVE_MODULES = (
    "repro_torch.dist",
    "repro_torch.dist.sharding",
    "repro_torch.models.blocks",
    "repro_torch.models.convert",
    "repro_torch.models.lm",
    "repro_torch.models.layers.attention",
    "repro_torch.models.layers.common",
    "repro_torch.models.layers.embedding",
    "repro_torch.models.layers.frontend",
    "repro_torch.models.layers.mlp",
    "repro_torch.models.layers.moe",
    "repro_torch.models.layers.norms",
    "repro_torch.models.layers.rope",
    "repro_torch.models.layers.ssm",
    "repro_torch.models.layers.xlstm",
    "repro_torch.serve",
    "repro_torch.serve.decode",
    "repro_torch.serve.paging",
)


# The modules of the training slice (optimizer, data pipeline and packing,
# train step and trainer, checkpointing): each must be found by the import
# sweep and be free of JAX and the reference on its own.
TRAINING_MODULES = (
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.manager",
    "repro_torch.data",
    "repro_torch.data.packing",
    "repro_torch.data.pipeline",
    "repro_torch.optim",
    "repro_torch.optim.adamw",
    "repro_torch.optim.compression",
    "repro_torch.optim.schedule",
    "repro_torch.train",
    "repro_torch.train.step",
    "repro_torch.train.trainer",
)

# The reference's names of the training packages that wait for the
# torch.distributed slice (ROADMAP Queue 1 item 8): a collective inside
# shard_map, the batch's and the step's mesh shardings.
WAITING_FOR_DISTRIBUTED = {"compressed_psum", "make_batch_specs",
                           "shardings_for"}


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_static_scan_finds_no_jax_or_reference_import():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert offenders == []


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    assert "repro_torch.kernels.scan_engine.schedules" in mods
    assert set(RELATIONAL_MODULES) <= set(mods)
    assert set(ATTENTION_MODULES) <= set(mods)
    assert set(CORE_CONFIG_MODULES) <= set(mods)
    assert set(MODEL_SERVE_MODULES) <= set(mods)
    assert set(TRAINING_MODULES) <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", RELATIONAL_MODULES)
def test_relational_module_imports_no_jax(module):
    assert module in set(_modules())
    rel = pathlib.Path(*module.split("."))
    path = PKG.parent / rel / "__init__.py"
    if not path.exists():
        path = (PKG.parent / rel).with_suffix(".py")
    assert FORBIDDEN.findall(path.read_text()) == []


@pytest.mark.parametrize("module", AFFINE_MODULES)
def test_affine_module_imports_no_jax(module):
    assert module in set(_modules())
    rel = pathlib.Path(*module.split("."))
    path = PKG.parent / rel / "__init__.py"
    if not path.exists():
        path = (PKG.parent / rel).with_suffix(".py")
    assert FORBIDDEN.findall(path.read_text()) == []


@pytest.mark.parametrize("module", ATTENTION_MODULES)
def test_attention_module_imports_no_jax(module):
    assert module in set(_modules())
    rel = pathlib.Path(*module.split("."))
    path = PKG.parent / rel / "__init__.py"
    if not path.exists():
        path = (PKG.parent / rel).with_suffix(".py")
    assert FORBIDDEN.findall(path.read_text()) == []


@pytest.mark.parametrize("module", CORE_CONFIG_MODULES)
def test_core_config_module_imports_no_jax(module):
    assert module in set(_modules())
    rel = pathlib.Path(*module.split("."))
    path = PKG.parent / rel / "__init__.py"
    if not path.exists():
        path = (PKG.parent / rel).with_suffix(".py")
    assert FORBIDDEN.findall(path.read_text()) == []


@pytest.mark.parametrize("module", MODEL_SERVE_MODULES)
def test_model_serve_module_imports_no_jax(module):
    assert module in set(_modules())
    rel = pathlib.Path(*module.split("."))
    path = PKG.parent / rel / "__init__.py"
    if not path.exists():
        path = (PKG.parent / rel).with_suffix(".py")
    assert FORBIDDEN.findall(path.read_text()) == []


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_module_imports_no_jax(module):
    assert module in set(_modules())
    rel = pathlib.Path(*module.split("."))
    path = PKG.parent / rel / "__init__.py"
    if not path.exists():
        path = (PKG.parent / rel).with_suffix(".py")
    text = path.read_text()
    assert FORBIDDEN.findall(text) == []
    assert re.findall(r"^\s*(?:import|from) ml_dtypes", text, re.M) == []


@pytest.mark.parametrize("package", ("optim", "data", "train", "checkpoint"))
def test_training_package_mirrors_reference(package):
    """``optim``, ``data``, ``train`` and ``checkpoint``: the reference's
    modules and ``__all__`` (read from its source) but the names that wait
    for the torch.distributed slice (``make_batch_specs``; ``optim``'s
    ``__all__`` never held ``compressed_psum``); each module defines the
    reference module's public names but those (``compressed_psum``,
    ``shardings_for``) and the ``Pytree`` type alias; every name
    resolves."""
    import importlib
    mod = importlib.import_module(f"repro_torch.{package}")
    ref_dir = ROOT / "src" / "repro" / package
    port_dir = PKG / package
    assert sorted(p.name for p in port_dir.glob("*.py")) == \
        sorted(p.name for p in ref_dir.glob("*.py"))
    ref = _reference_all(ref_dir / "__init__.py")
    assert set(mod.__all__) == ref - WAITING_FOR_DISTRIBUTED
    for name in mod.__all__:
        assert hasattr(mod, name), name
    for path in ref_dir.glob("*.py"):
        if path.name == "__init__.py":
            continue
        missing = _module_names(path) - _module_names(port_dir / path.name)
        assert missing <= WAITING_FOR_DISTRIBUTED | {"Pytree"}, \
            (path.name, missing)


def test_lm_takes_remat_and_unroll():
    """``models/lm.py``'s ``forward`` and ``lm_loss`` take the reference's
    ``remat`` and ``unroll`` keywords with its defaults; ``convert`` has
    ``tree_from_lm``."""
    import inspect
    from repro_torch.models import convert, lm
    for fn in (lm.forward, lm.lm_loss):
        params = inspect.signature(fn).parameters
        assert params["remat"].default is False, fn
        assert params["unroll"].default is False, fn
    assert callable(convert.tree_from_lm)


def test_dist_exports_a_subset_of_reference():
    """``dist``: the reference's ``__all__`` (read from its source) but the
    multi-device names, which wait for the torch.distributed slice; the
    single-device surface of ``sharding.py`` beside them."""
    from repro_torch import dist
    ref = _reference_all(ROOT / "src" / "repro" / "dist" / "__init__.py")
    assert set(dist.__all__) == ref - {"sanitize_spec", "shard_map",
                                       "spec_for_params"}
    for name in dist.__all__:
        assert hasattr(dist, name), name
    for name in ("current_mesh", "current_rules", "use_mesh", "resolve",
                 "shard", "DEFAULT_RULES"):
        assert hasattr(dist.sharding, name), name


def test_serve_exports_the_reference_paging_names():
    """``serve``: exactly the names the reference's ``serve`` exports from
    ``paging`` (its engine, steps, sampling, stats and faults wait), and
    ``paging`` defines every public name of the reference's module."""
    from repro_torch import serve
    ref_dir = ROOT / "src" / "repro" / "serve"
    ref = _reference_all(ref_dir / "__init__.py")
    block = re.search(r"from repro\.serve\.paging import \((.*?)\)",
                      (ref_dir / "__init__.py").read_text(), re.S).group(1)
    paging_names = set(re.findall(r"\w+", block))
    assert paging_names <= ref
    assert set(serve.__all__) == paging_names
    for name in serve.__all__:
        assert hasattr(serve, name), name
    assert _module_names(ref_dir / "paging.py") <= _module_names(
        PKG / "serve" / "paging.py")


def test_models_mirror_reference():
    """``models``: the reference's layer modules, ``blocks.py`` and
    ``lm.py`` (``encdec.py`` waits), plus ``convert.py``; ``lm.py``
    defines the reference's forward functions."""
    ref_dir = ROOT / "src" / "repro" / "models"
    port_dir = PKG / "models"
    assert sorted(p.name for p in (port_dir / "layers").glob("*.py")) == \
        sorted(p.name for p in (ref_dir / "layers").glob("*.py"))
    assert sorted(p.name for p in port_dir.glob("*.py")) == sorted(
        [p.name for p in ref_dir.glob("*.py") if p.name != "encdec.py"]
        + ["convert.py"])
    assert {"init_lm", "init_cache", "forward", "prefill", "decode_step",
            "chunked_ce_loss", "lm_loss"} <= _module_names(port_dir / "lm.py")


def test_flash_attention_package_mirrors_reference():
    """Same module names and the same ``__all__`` as the reference's
    ``kernels/flash_attention`` (read from its source: no JAX import)."""
    ref_dir = ROOT / "src" / "repro" / "kernels" / "flash_attention"
    port_dir = PKG / "kernels" / "flash_attention"
    assert sorted(p.name for p in port_dir.glob("*.py")) == \
        sorted(p.name for p in ref_dir.glob("*.py"))
    all_re = re.compile(r"^__all__ = (\[[^\]]*\])", re.M | re.S)
    for name in ("__init__.py", "flash_attention.py"):
        want = all_re.search((ref_dir / name).read_text()).group(1)
        got = all_re.search((port_dir / name).read_text()).group(1)
        assert sorted(eval(got)) == sorted(eval(want)), name


def test_core_scan_package_mirrors_reference():
    """``core.scan``: the reference's modules and ``__all__`` (read from
    its source), but the distributed forms (``distributed.py``,
    ``scan_sharded``, ``make_sharded_cumsum``), which wait for the
    ``torch.distributed`` slice; every name resolves."""
    from repro_torch.core import scan
    ref_dir = ROOT / "src" / "repro" / "core" / "scan"
    port_dir = PKG / "core" / "scan"
    assert sorted(p.name for p in port_dir.glob("*.py")) == sorted(
        p.name for p in ref_dir.glob("*.py") if p.name != "distributed.py")
    ref = _reference_all(ref_dir / "__init__.py")
    assert set(scan.__all__) == ref - {"scan_sharded", "make_sharded_cumsum"}
    assert {"MATRIX_AFFINE", "SOFTMAX_PAIR", "scan_tree",
            "scan_vertical"} <= set(scan.__all__)
    for name in scan.__all__:
        assert hasattr(scan, name), name


def test_configs_package_mirrors_reference():
    """``configs``: the reference's modules and ``__all__`` (read from
    its source), and ``models/config.py`` beside them."""
    from repro_torch import configs
    ref_dir = ROOT / "src" / "repro" / "configs"
    port_dir = PKG / "configs"
    assert sorted(p.name for p in port_dir.glob("*.py")) == \
        sorted(p.name for p in ref_dir.glob("*.py"))
    assert set(configs.__all__) == _reference_all(ref_dir / "__init__.py")
    for name in configs.__all__:
        assert hasattr(configs, name), name
    assert (PKG / "models" / "config.py").exists()
    assert _module_names(PKG / "models" / "config.py") == _module_names(
        ROOT / "src" / "repro" / "models" / "config.py")


def _reference_all(path):
    all_re = re.compile(r"^__all__ = (\[[^\]]*\])", re.M | re.S)
    return set(eval(all_re.search(path.read_text()).group(1)))


def _module_names(path):
    """The public names a module defines at its top level (functions,
    classes and assignments), read from its source."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_scan_engine_all_mirrors_reference():
    """The engine's ``__all__`` holds the reference's (read from its
    source: no JAX import), ``fused_native_available`` among them, and
    adds only the two kernel modules; every name resolves."""
    from repro_torch.kernels import scan_engine
    ref = _reference_all(ROOT / "src" / "repro" / "kernels" / "scan_engine"
                         / "__init__.py")
    assert "fused_native_available" in ref
    assert set(scan_engine.__all__) - ref == {"cuda", "cuda_fold"}
    assert ref <= set(scan_engine.__all__)
    for name in scan_engine.__all__:
        assert hasattr(scan_engine, name), name


def test_monoids_mirror_reference():
    """``monoids`` defines the reference's names (``softmax_pair`` and the
    five-entry ``REGISTRY`` among them), and its registry the same keys."""
    from repro_torch.kernels.scan_engine import monoids
    ref_path = ROOT / "src" / "repro" / "kernels" / "scan_engine" / \
        "monoids.py"
    ref = _module_names(ref_path)
    assert {"softmax_pair", "REGISTRY"} <= ref
    assert ref <= _module_names(PKG / "kernels" / "scan_engine" /
                                "monoids.py")
    keys = re.search(r"^REGISTRY = \{(.*?)^\}", ref_path.read_text(),
                     re.M | re.S).group(1)
    assert set(re.findall(r'"(\w+)":', keys)) == set(monoids.REGISTRY)


def test_fused_native_available_off_cuda(monkeypatch):
    """False off CUDA, without building anything; on a CUDA device it
    reports whether the kernel library builds or is there."""
    import torch
    from repro_torch.kernels.scan_engine import cuda, schedules
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cuda, "build", lambda: pytest.fail("built"))
    assert schedules.fused_native_available() is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(cuda, "build", no_nvcc)
    assert schedules.fused_native_available() is False
    monkeypatch.setattr(cuda, "build", lambda: object())
    assert schedules.fused_native_available() is True


# The reference tests' uses of the registration surface, re-run on the
# port (tests/test_flash_engine.py::test_softmax_pair_registered_with_engine,
# tests/test_scan_engine.py::test_registry_covers_five_families and
# ::test_tree_fold_routes_to_carry_fold).


def test_port_softmax_pair_registered_with_engine():
    from repro_torch.core.scan import assoc
    from repro_torch.kernels import scan_engine
    assert "softmax_pair" in scan_engine.monoids.REGISTRY
    spec = scan_engine.monoids.REGISTRY["softmax_pair"]()
    assert isinstance(spec, assoc.KernelSpec)
    assert spec.n_leaves == 3              # (m, l, acc) payload triple
    assert spec.transform is not None and spec.finalize is not None
    assert not spec.supports_exclusive


def test_port_registry_covers_five_families():
    from repro_torch.core.scan import assoc
    from repro_torch.kernels import scan_engine
    assert set(scan_engine.monoids.REGISTRY) == {
        "sum", "segmented_sum", "affine", "mask", "softmax_pair"}
    for name, factory in scan_engine.monoids.REGISTRY.items():
        spec = factory()
        assert isinstance(spec, assoc.KernelSpec)
        assert len(spec.fills) == spec.n_leaves


def test_port_tree_fold_routes_to_carry_fold():
    """Carried-payload monoids have no in-block element axis to
    tree-organize: schedule='tree' runs the carry fold, same bits."""
    import numpy as np
    import torch
    from repro_torch.kernels import scan_engine
    rng = np.random.default_rng(26)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, 16))
                                .astype(np.float32)) for _ in range(3))
    spec = scan_engine.monoids.softmax_pair(scale=0.25)
    lay = scan_engine.KVBlocks(bh=2, bh_kv=2, tq=128, tk=128, d=16,
                               bq=128, bk=64)
    out_t = scan_engine.scan((q, k, v), spec, lay, schedule="tree")
    out_c = scan_engine.scan((q, k, v), spec, lay, schedule="carry")
    assert len(out_t) == len(out_c)
    for a, b in zip(out_t, out_c):
        assert torch.equal(a, b)
