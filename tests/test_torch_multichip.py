"""PyTorch port, the multi-card dry run (scripts/multichip.py) on the CPU:
two gloo ranks and a mesh of two 'cpu' entries at the flagship's full
width, rows cut to one per card for serving.

- The widths: 1, 2, 4, ... below n, and n (the JAX dry run's sweep).
- Training: each width spawns its ranks with torchrun's environment and
  returns each step's loss, gradient norm and host ms. Width 2's first step
  holds every ddp gate against width 1's (chip_smoke.py's ddp phase: loss,
  each tensor's update and the whole update, BN statistics), the gradient
  norm at the CPU's gate (multichip.CPU_NORM_RTOL: the mel mixer's float32
  gradient on the CPU reads 1.8e-4 from width 1 at two ranks), and its
  3-step parameters lie within the JAX dry run's bound (2e-2). Each width's
  first-step gradient norm is within that gate of the same step in float64
  (the gap between widths is each process's own float32 rounding).
- The gates themselves: step_gates reads zero on a step against itself and
  fails a step whose update or BN statistics differ.
- Serving: every leg over the mesh at its gate, no frontend kernel launched
  on the CPU.
"""

import copy
import tempfile
from pathlib import Path

import numpy as np
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
from birdnet_stm32_tpu_torch.parallel.steps import conv_kernel_l2, global_norm, loss_and_grads
from birdnet_stm32_tpu_torch.scripts import multichip as MC
from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401

warm_up()


def test_widths():
    assert MC.widths(1) == [1]
    assert MC.widths(2) == [1, 2]
    assert MC.widths(4) == [1, 2, 4]
    assert MC.widths(6) == [1, 2, 4, 6]
    assert MC.widths(8) == [1, 2, 4, 8]


def _float64_grad_norm(cfg, model) -> float:
    """The gradient norm of make_train_step's first step (the loss on the
    logits plus the kernels' L2, dropout off) on the sweep's first global
    batch, in float64 in this process."""
    x, y = (t[0].double() for t in MC.train_batches(cfg, "cpu"))
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if isinstance(mod, (torch.nn.Dropout, torch.nn.Dropout2d)):
            mod.p = 0.0
    m.train()
    params = dict(m.named_parameters())
    loss = make_loss_fn(multilabel=True, device="cpu")(m(x), y) + conv_kernel_l2(params, 1e-4)
    return float(global_norm(loss_and_grads(loss, params)[1]))


def test_train_sweep_on_two_gloo_ranks():
    cfg = ModelConfig.load(MC.BUNDLE / "model_config.json")
    model = init_model(build_dscnn(cfg, class_activation="none", device="cpu"), seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        lines, ok = MC.train_sweep(cfg, model, 2, "cpu", Path(tmp))
    assert [line["width"] for line in lines] == [1, 2]
    for line in lines:
        assert len(line["loss"]) == MC.TRAIN_STEPS and np.isfinite(line["loss"]).all()
        assert len(line["rank0_step_ms"]) == MC.TRAIN_STEPS
    # The gradient-norm gap is one process's own float32 rounding: each
    # width's first-step norm against the same step in float64.
    f64 = _float64_grad_norm(cfg, model)
    gaps = [abs(line["grad_norm"][0] - f64) / f64 for line in lines]
    print(f"first-step gradient norm against float64, widths 1 / 2: {gaps}")
    assert max(gaps) <= MC.CPU_NORM_RTOL
    gates = lines[1]["gate_step"]
    assert gates["loss_rel"] <= MC.LOSS_RTOL
    assert gates["grad_norm_rel"] <= MC.CPU_NORM_RTOL
    assert gates["worst_tensor_update_rel"] <= MC.TENSOR_UPDATE_RTOL
    assert gates["update_l2_rel"] <= MC.UPDATE_RTOL
    assert gates["worst_bn_stat_rel"] <= MC.STATS_RTOL
    assert gates["hold"] and ok
    assert lines[1]["trajectory"]["max_abs_param_delta"] <= MC.PARAM_DELTA_BOUND
    assert lines[1]["trajectory"]["hold"]


def _step(loss, norm, variables):
    return {"loss": [loss], "grad_norm": [norm], "variables": variables}


def test_step_gates_catch_a_wrong_update_and_wrong_statistics():
    g = torch.Generator().manual_seed(0)
    start = {"conv.weight": torch.randn(4, 3, generator=g),
             "bn.running_mean": torch.randn(4, generator=g),
             "bn.num_batches_tracked": torch.tensor(1)}
    ref = {k: v + 0.1 for k, v in start.items()}
    same = MC.step_gates(_step(1.0, 2.0, ref), _step(1.0, 2.0, ref), start)
    assert same["hold"] and max(v for k, v in same.items() if k != "hold") == 0.0
    # A tensor's update 10 % off, BN statistics 1e-3 off, and a gradient
    # norm 5e-4 off (within the CPU's gate, not the card's).
    wrong_update = {**ref, "conv.weight": start["conv.weight"] + 0.11}
    wrong_stats = {**ref, "bn.running_mean": ref["bn.running_mean"] * (1 + 1e-3)}
    assert not MC.step_gates(_step(1.0, 2.0, wrong_update), _step(1.0, 2.0, ref), start)["hold"]
    assert not MC.step_gates(_step(1.0, 2.0, wrong_stats), _step(1.0, 2.0, ref), start)["hold"]
    off_norm = _step(1.0, 2.0 * (1 + 5e-4), ref)
    assert not MC.step_gates(off_norm, _step(1.0, 2.0, ref), start)["hold"]
    assert MC.step_gates(off_norm, _step(1.0, 2.0, ref), start, MC.CPU_NORM_RTOL)["hold"]


def test_serve_sweep_over_a_cpu_mesh():
    cfg = ModelConfig.load(MC.BUNDLE / "model_config.json")
    lines, ok = MC.serve_sweep(cfg, 2, "cpu", rows_per_card=1)
    assert ok
    assert [(line["leg"], line["width"]) for line in lines] == [
        (leg, w) for leg in ("int8", "float32", "bf16") for w in (1, 2)]
    for line in lines:
        assert line["gates_hold"] and line["frontend_launches_per_batch"] == 0
        assert line["rows"] == 2 and line["chunks_per_s"] > 0
    assert all(line["bit_equal"] for line in lines if line["leg"] == "int8")
    assert torch.get_num_threads() == 1
