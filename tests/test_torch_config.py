"""The port's own copies of `config/` against the JAX package's, and
`build_model` / `JPerceiver.from_config` against the JAX `from_config`.

For every preset file and every `list_families()` entry, the port builds
its model from the config (on PyTorch's meta device: shapes only) and the
JAX package builds its own; the port's parameter and statistic names and
shapes must equal those of the JAX tree passed through
`convert.state_dict_from_jax`, key for key (configs that agree in every key
`from_config` reads are built once). The JAX trees come from
`jax.eval_shape` of `init` (no compile), one per combination of the axes
that shape a tree (layers, occ, frames, branches, num_class). The
optimizer labels of the flagship tree (`param_labels` against the JAX
`_label_params`) are compared here too, through the same bridge.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jperceiver_tpu.config import Config as JaxConfig
from jperceiver_tpu.config import build_family as jax_build_family
from jperceiver_tpu.config import family_axes as jax_family_axes
from jperceiver_tpu.config import list_families as jax_list_families
from jperceiver_tpu.engine.optim import _label_params
from jperceiver_tpu.models import JPerceiver as JaxJPerceiver
from jperceiver_tpu_torch.config import Config, build_family, family_axes, list_families
from jperceiver_tpu_torch.convert import state_dict_from_jax
from jperceiver_tpu_torch.engine.optim import param_labels
from jperceiver_tpu_torch.models import MODELS, JPerceiver, build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(ROOT, "jperceiver_tpu", "config", "presets", "*.py")))


def _preset(pkg, name):
    return os.path.join(ROOT, pkg, "config", "presets", name)


def _configs():
    """(id, port model config, JAX model config) for every preset and family."""
    out = [(f"preset:{p}", Config.fromfile(_preset("jperceiver_tpu_torch", p)).model,
            JaxConfig.fromfile(_preset("jperceiver_tpu", p)).model) for p in PRESETS]
    out += [(f"family:{f}", build_family(f).model, jax_build_family(f).model)
            for f in jax_list_families()]
    return out


def test_presets_and_families_are_copies():
    assert PRESETS and PRESETS == sorted(os.path.basename(p) for p in glob.glob(
        _preset("jperceiver_tpu_torch", "*.py")))
    for p in PRESETS:
        assert (Config.fromfile(_preset("jperceiver_tpu_torch", p)).to_dict()
                == JaxConfig.fromfile(_preset("jperceiver_tpu", p)).to_dict()), p
    assert list_families() == jax_list_families()
    for f in list_families():
        assert family_axes(f) == jax_family_axes(f)
        assert build_family(f, total_epochs=3).to_dict() == \
            jax_build_family(f, total_epochs=3).to_dict(), f


def test_config_access_and_overrides():
    cfg = Config.fromdict({"model": {"height": 64, "scales": [0, 1]}, "lr": 1e-4})
    assert cfg.model.height == 64 and cfg["lr"] == 1e-4 and "model" in cfg
    cfg.merge_from_dict({"model.height": 128, "data.name": "simulated"})
    assert cfg.model.height == 128 and cfg.data.name == "simulated"
    with pytest.raises(AttributeError):
        cfg.model.missing


@functools.lru_cache(maxsize=None)
def _jax_shapes(depth, pose, occ, frames, branches, num_class):
    """The JAX JPerceiver's variable shapes, from `jax.eval_shape` of init."""
    model = JaxJPerceiver(depth_layers=depth, pose_layers=pose, frame_ids=frames,
                          height=4 * occ, width=4 * occ, occ_map_size=occ,
                          num_class=num_class, branches=branches)
    batch = {"color_aug": jnp.zeros((1, len(frames), 4 * occ, 4 * occ, 3))}
    return jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch, train=True))


def _tree_key(jm):
    return (jm.depth_layers, jm.pose_layers, jm.occ_map_size, tuple(jm.frame_ids),
            jm.branches, jm.num_class)


def _bridge(tree, fill):
    """state_dict_from_jax of a shape tree whose leaves `fill(i, shape)`
    makes, the i-th in flattening order."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(
        treedef, [fill(i, leaf.shape) for i, leaf in enumerate(leaves)])


@functools.lru_cache(maxsize=None)
def _bridged_shapes(key):
    shapes = _jax_shapes(*key)
    sd = state_dict_from_jax(*(_bridge(shapes[c], lambda i, s: np.zeros(s, np.float16))
                               for c in ("params", "batch_stats")))
    return {k: tuple(v.shape) for k, v in sd.items()}


# The keys `JPerceiver.from_config` reads; configs equal in all of them
# build one model, which is built and checked once.
_MODEL_KEYS = ("name", "compute_dtype", "depth_num_layers", "pose_num_layers", "frame_ids",
               "height", "width", "occ_map_size", "num_class", "scales", "min_depth",
               "max_depth", "remat", "type", "skip_inactive_branch")


def _model_key(cfg):
    return repr([cfg.get(k) for k in _MODEL_KEYS])


def test_from_config_matches_jax_for_every_preset_and_family():
    seen = set()
    for name, pcfg, jcfg in _configs():
        if _model_key(pcfg) in seen:
            continue
        seen.add(_model_key(pcfg))
        jm = JaxJPerceiver.from_config(jcfg)
        want = _bridged_shapes(_tree_key(jm))
        with torch.device("meta"):
            model = build_model(pcfg)
        assert isinstance(model, JPerceiver)
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == want, (name, sorted(set(got) ^ set(want))[:5])
        assert model.branches == jm.branches, name
        assert model.frame_ids == tuple(jm.frame_ids)
        assert (model.height, model.width, model.occ_map_size, model.num_class) == (
            jm.height, jm.width, jm.occ_map_size, jm.num_class), name
        assert model.scales == tuple(jm.scales)
        assert (model.min_depth, model.max_depth, model.remat) == (
            jm.min_depth, jm.max_depth, jm.remat), name
        assert model.dtype == {jnp.float32: torch.float32,
                               jnp.bfloat16: torch.bfloat16}[jm.dtype]


def test_from_config_keys():
    cfg = {"name": "JPerceiver", "compute_dtype": "bfloat16", "type": "Argo_both",
           "occ_map_size": 128, "remat": "enc", "skip_inactive_branch": True}
    with torch.device("meta"):
        m = build_model(cfg)
    assert (m.dtype, m.branches, m.occ_map_size) == (torch.bfloat16, "both", 128)
    assert m.remat_trunks == {"DepthEncoder", "PoseEncoder", "LayoutEncoder"}
    for t, skip, want in (("static_raw", True, "road"), ("dynamic", True, "vehicle"),
                          ("static", False, "both")):
        assert JPerceiver.branches_from_cfg({"type": t, "skip_inactive_branch": skip}) == want
        assert JaxJPerceiver._branches_from_cfg(
            JaxConfig.fromdict({"type": t, "skip_inactive_branch": skip})) == want
    with pytest.raises(KeyError, match="unknown model"):
        build_model({"name": "Nope"})
    assert MODELS["JPerceiver"] is JPerceiver
    for bad in ("both", "decoder", 2):
        with pytest.raises(ValueError, match="remat"):
            JPerceiver(remat=bad, occ_map_size=32)


def test_param_labels_match_jax_on_the_flagship_tree():
    """The labels of `bias_lr_mult`: the port reads the layer type, JAX the
    flax path; through the bridge they label every parameter alike."""
    cfg = JaxConfig.fromfile(_preset("jperceiver_tpu", "kitti_odom_1024.py")).model
    params = _jax_shapes(*_tree_key(JaxJPerceiver.from_config(cfg)))["params"]
    jax_labels = jax.tree_util.tree_leaves(_label_params(params))
    index = state_dict_from_jax(
        _bridge(params, lambda i, s: np.full((1,) * len(s), i, np.float32)), {})
    want = {k: jax_labels[int(v.reshape(-1)[0])] for k, v in index.items()}
    with torch.device("meta"):
        model = build_model(Config.fromfile(_preset("jperceiver_tpu_torch",
                                                     "kitti_odom_1024.py")).model)
    got = param_labels(model)
    assert got == want
    assert {"norm", "bias", "default"} == set(got.values())
