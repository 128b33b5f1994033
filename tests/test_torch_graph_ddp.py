"""The captured data-parallel step's decisions and bookkeeping, on the CPU
(`engine/graphs.py`, `parallel/dist.py`, DDP in `engine/trainer.py`).

Which calls an entry point captures under each process group
(`use_graphs`): a body with collectives, the training step, captures by
default under one NCCL rank on a card, on request (`graph=True`) under
more, and stays eager under gloo, whose collectives run on the host; a
body without collectives, the eval step and streaming, captures under any
group. The backends are monkeypatched into `torch.distributed`
here: the CPU build has no card and no NCCL. `GraphCache`'s warm-ups with a
stand-in graph: exactly `warmup` eager calls, `DDP_WARMUP` under a
process group, counted across keys (DDP's iterations), then one capture a
key, then replays.

Two gloo ranks (`tests/torch_ddp_worker.py graph`, one intra-op thread a
process): DDP built with `static_graph=True` against DDP built without
it, two fp32 steps of the 128^2 step from the same weights and batches,
every metric, gradient and weight bit for bit; the
step stays eager under gloo and `graph=True` raises naming gloo; the
capture's check that every rank captures the same key passes for the
same key and raises on both ranks for different keys.
"""

import contextlib
import os

import pytest
import torch

from jperceiver_tpu_torch.data import synthetic_batch
from jperceiver_tpu_torch.engine import graphs
from jperceiver_tpu_torch.engine import infer as infer_module
from jperceiver_tpu_torch.engine import streaming as streaming_module
from jperceiver_tpu_torch.engine import trainer as trainer_module
from jperceiver_tpu_torch.models import JPerceiver
from jperceiver_tpu_torch.parallel import dist as port_dist

from test_torch_parallel import _free_port, _spawn, _wait
from torch_ddp_worker import FLAGSHIP, GLOBAL_B, H, OCC, W

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group(monkeypatch, backend, nccl=(2, 21, 5), world=1):
    """A process group of `backend` and `world` ranks, as
    `torch.distributed` reports it, with a card and `nccl` as PyTorch's
    NCCL version."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: backend)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: world)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nccl, "version", lambda: nccl)


def test_use_graphs_without_a_process_group():
    for collectives in (True, False):
        assert graphs.use_graphs(None, CUDA, "x", collectives=collectives)
        assert not graphs.use_graphs(None, CPU, "x", collectives=collectives)
        assert not graphs.use_graphs(False, CUDA, "x", collectives=collectives)
        with pytest.raises(ValueError, match="graph=True"):
            graphs.use_graphs(True, CPU, "x", collectives=collectives)
    assert port_dist.backend() is None and not port_dist.can_capture()


def test_use_graphs_under_gloo(monkeypatch):
    _group(monkeypatch, "gloo")
    assert port_dist.backend() == "gloo" and not port_dist.can_capture()
    assert not graphs.use_graphs(None, CUDA, "the step", collectives=True)
    with pytest.raises(ValueError, match="process group on gloo"):
        graphs.use_graphs(True, CUDA, "the step", collectives=True)
    # The eval step and streaming have no collective: captured under gloo too.
    assert graphs.use_graphs(None, CUDA, "eval", collectives=False)
    assert graphs.use_graphs(True, CUDA, "eval", collectives=False)


def test_use_graphs_under_nccl(monkeypatch):
    _group(monkeypatch, "nccl")
    assert port_dist.backend() == "nccl" and port_dist.can_capture()
    for collectives in (True, False):
        assert graphs.use_graphs(None, CUDA, "x", collectives=collectives)
        assert graphs.use_graphs(True, CUDA, "x", collectives=collectives)
        assert not graphs.use_graphs(False, CUDA, "x", collectives=collectives)
    # More ranks: the step's collectives are captured on request only.
    _group(monkeypatch, "nccl", world=2)
    assert not graphs.use_graphs(None, CUDA, "the step", collectives=True)
    assert graphs.use_graphs(True, CUDA, "the step", collectives=True)
    assert graphs.use_graphs(None, CUDA, "eval", collectives=False)


def test_nccl_that_cannot_capture_raises_naming_the_versions(monkeypatch):
    _group(monkeypatch, "nccl", nccl=(2, 8, 4))
    with pytest.raises(RuntimeError, match=r"NCCL 2\.8\.4.*2\.9\.6"):
        graphs.use_graphs(None, CUDA, "the step", collectives=True)
    # Without collectives nothing asks NCCL.
    assert graphs.use_graphs(None, CUDA, "eval", collectives=False)
    _group(monkeypatch, "nccl")
    monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", "0")
    with pytest.raises(RuntimeError, match="NCCL_GRAPH_MIXING_SUPPORT"):
        port_dist.can_capture()


def test_entry_points_declare_their_collectives(monkeypatch):
    """The training step's body has collectives under a group, the eval
    step's and a streaming chunk's have none."""
    said = {}

    def spy(graph, device, what, *, collectives):
        said[what] = collectives
        return False

    for module in (infer_module, streaming_module, trainer_module):
        monkeypatch.setattr(module, "use_graphs", spy)
    torch.manual_seed(0)
    model = JPerceiver(height=H, width=W, occ_map_size=OCC, branches="road")
    infer_module.make_eval_step(model, device="cpu")
    streaming_module.make_streaming_fn(model, device="cpu")
    step = trainer_module.make_train_step(model, FLAGSHIP, device="cpu", steps_per_epoch=10)
    assert said == {"make_eval_step": False, "make_streaming_fn": False,
                    "make_train_step": True}
    # One process: a key's first call is its one warm-up, no key check.
    assert step.graphs.warmup == 1 and not step.graphs.collectives


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def register_generator_state(self, gen):
        pass

    def replay(self):
        self.replays += 1


def test_graph_cache_warms_up_across_keys_then_captures_each_key(monkeypatch):
    """Under a process group with `DDP_WARMUP` 3 (DDP's count, not a
    key's): keys a, b, a eager; then a captures and replays, b captures
    and replays, a and b replay; a third key gets its one eager call, then
    captures."""
    monkeypatch.setattr(graphs, "DDP_WARMUP", 3)
    monkeypatch.setattr(graphs.dist, "is_distributed", lambda: True)
    made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: made.append(_StandInGraph()) or made[-1])
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    calls = []

    def body(x):
        calls.append(float(x[0]))
        return {"y": x * 2}

    cache = graphs.GraphCache(body, "the test body", collectives=True)
    assert cache.warmup == 3 and cache.collectives
    assert graphs.GraphCache(body, "without collectives").warmup == 1
    seq = [("a", 1.0), ("b", 2.0), ("a", 3.0), ("a", 4.0), ("b", 5.0), ("a", 6.0), ("b", 7.0),
           ("c", 8.0), ("c", 9.0), ("c", 10.0)]
    for key, v in seq:
        cache.run(key, {"x": torch.full((2,), v)})
    # Eager: a, b, a, then c's first call; captures: a, b, c (each runs the
    # body once, on its static copy); replays do not run the Python body.
    assert calls == [1.0, 2.0, 3.0, 4.0, 5.0, 8.0, 9.0]
    assert cache.eager_calls == 4 and cache.captures == 3 == len(made)
    assert [g.replays for g in made] == [2, 2, 2]
    assert sorted(cache.entries) == ["a", "b", "c"]
    # A restore drops the graphs: each key warms up once more, then captures.
    cache.clear()
    cache.run("a", {"x": torch.full((2,), 11.0)})
    cache.run("a", {"x": torch.full((2,), 12.0)})
    assert calls[-2:] == [11.0, 12.0] and cache.captures == 4


def test_train_step_warms_up_for_ddp(monkeypatch):
    """Under a process group the step's cache waits `DDP_WARMUP` eager
    iterations, PyTorch's recipe for capturing DDP."""
    class _DDP(torch.nn.Module):
        def __init__(self, module, **kw):
            super().__init__()
            self.module, self.kw = module, kw

    monkeypatch.setattr(torch.nn.parallel, "DistributedDataParallel", _DDP)
    monkeypatch.setattr(trainer_module.dist, "is_distributed", lambda: True)
    monkeypatch.setattr(trainer_module.dist, "world_size", lambda: 1)
    monkeypatch.setattr(graphs.dist, "is_distributed", lambda: True)
    torch.manual_seed(0)
    model = JPerceiver(height=H, width=W, occ_map_size=OCC, branches="road")
    step = trainer_module.make_train_step(model, FLAGSHIP, device="cpu", steps_per_epoch=10)
    assert step.ddp.kw == {"device_ids": None, "broadcast_buffers": False,
                           "find_unused_parameters": False, "static_graph": True}
    assert step.graphs.warmup == graphs.DDP_WARMUP == 11 and not step.graphed


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Two gloo ranks of `torch_ddp_worker.py graph`."""
    d = str(tmp_path_factory.mktemp("graph_ddp"))
    torch.manual_seed(4)
    model = JPerceiver(height=H, width=W, occ_map_size=OCC, branches="road")
    torch.save({"weights": model.state_dict(),
                "batch": synthetic_batch(GLOBAL_B, H, W, OCC, seed=3)},
               os.path.join(d, "inputs.pt"))
    port = _free_port()
    _wait([_spawn("graph", d, port, r) for r in range(2)])
    return [torch.load(os.path.join(d, f"graph{r}.pt"), weights_only=False) for r in range(2)]


def test_static_graph_ddp_gives_the_same_steps_bit_for_bit(gloo_ranks):
    for r in gloo_ranks:
        assert r["static_graph"] and not r["dynamic_static_graph"]
        assert r["same"]


def test_gloo_step_stays_eager_and_graph_true_names_gloo(gloo_ranks):
    for r in gloo_ranks:
        assert not r["graphed"] and r["warmup"] == 11
        assert "process group on gloo" in r["graph_true_refused"]
        assert r["decisions"] == {"train_none_on_cuda": False, "eval_none_on_cuda": True}


def test_capture_key_check_raises_on_a_mismatch(gloo_ranks):
    for r, out in enumerate(gloo_ranks):
        assert out["key_checks"]["same"] == "captured"
        assert f"the capture of the test body: rank {r} has 'k{r}'" in \
            out["key_checks"]["differ"]
