"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package."""

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
