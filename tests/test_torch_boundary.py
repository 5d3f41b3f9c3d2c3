"""The port stands alone: nothing under s2v_torch/, and not chip_smoke.py,
imports jax or s2v_tpu; importing s2v_torch pulls in neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "s2v_tpu")


def _port_files():
    return sorted((REPO / "s2v_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    assert path.exists()
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_leaves_jax_out(tmp_path):
    code = (
        "import sys; before = set(sys.modules); "
        "import s2v_torch, s2v_torch.pipelines.s2v, s2v_torch.loaders.jax_params, "
        "s2v_torch.kernels.flash_attention, s2v_torch.kernels.flash_attention_bwd, s2v_torch.utils.sp_native, "
        "s2v_torch.kernels.banded_attention, s2v_torch.kernels.banded_attention_bwd, "
        "s2v_torch.ops.windowed_attention, s2v_torch.kernels.int8_attention, s2v_torch.ops.quant, "
        "s2v_torch.training.lora, s2v_torch.training.optim, s2v_torch.training.data, s2v_torch.training.full, "
        "s2v_torch.parallel, s2v_torch.parallel.context, s2v_torch.parallel.sp_attention, s2v_torch.ops.attention; "
        "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 's2v_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
