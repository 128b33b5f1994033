"""The port stands alone: no module of `jperceiver_tpu_torch` (its
`evaluation/` and `tools/` included), nor the card scripts `chip_smoke.py`,
`chip_grad_routes.py` and `chip_conv_sweep.py`, imports JAX, its libraries
or the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "jperceiver_tpu"}
FILES = sorted((ROOT / "jperceiver_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_grad_routes.py", ROOT / "chip_conv_sweep.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("module", [
    "config/config.py", "config/families.py", "config/presets/kitti_odom_1024.py",
    "data/transforms.py", "data/calib.py", "data/velodyne.py", "data/kitti.py",
    "data/argoverse.py", "data/simulated.py", "data/splits.py", "data/loader.py",
    "engine/env.py", "engine/logger.py", "engine/trainer.py", "models/registry.py",
    "data/utils.py", "engine/checkpoint.py", "engine/eval_hook.py", "engine/optim.py",
    "evaluation/metrics.py", "evaluation/transforms.py", "evaluation/trajectory.py",
    "evaluation/kitti_odometry.py", "tools/train.py", "tools/eval_depth.py",
    "tools/draw_odometry.py", "tools/acceptance.py", "tools/plot_trajectory.py",
    "tools/make_splits.py", "tools/video_demo.py", "parallel/__init__.py", "parallel/dist.py",
    "data/aux_datasets.py", "data/folder.py", "tools/complexity.py", "tools/profile_step.py",
    "tools/trace_summary.py"])
def test_config_data_engine_modules_checked(module):
    """The config, data, engine, evaluation, parallel and tools modules,
    which copy JAX-package modules (some of which import no JAX), are among
    the files checked."""
    assert ROOT / "jperceiver_tpu_torch" / module in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN), path
