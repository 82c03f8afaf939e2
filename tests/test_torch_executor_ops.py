"""PyTorch port, INT8 executor: the op kinds beyond the flagship graph's,
requant='fast' and the layout pre-passes, against the JAX executor.

Each op kind runs in a tiny graph (tests/int8_op_graphs.py) through both
packages' executors on the same numpy inputs; the nine fuzz configurations'
committed graphs (tests/goldens/torch_fuzz, written by
tests/make_torch_fuzz_fixtures.py) run on their committed features.
Tolerance: none. The port must equal the jitted JAX executor bit for bit,
with requant 'exact' and 'fast', with and without its layout pre-passes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.quant import tflite_import as J
from birdnet_stm32_tpu_torch.quant import tflite_import as P
from tests.int8_fixture import FLAGSHIP_TFLITE, flagship_features
from tests.int8_op_graphs import KINDS, op_graph, op_inputs
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_fuzz_fixtures import N_CONFIGS, load

warm_up()

B = 3


def _jax_run(graph, x, requant="exact"):
    return np.asarray(jax.jit(J.build_executor(graph, x.shape[0], requant=requant))(
        jnp.asarray(x)))


def _port_run(graph, x, **kw):
    return P.build_executor(graph, x.shape[0], device="cpu", **kw)(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("requant", ["exact", "fast"])
@pytest.mark.parametrize("kind", KINDS)
def test_op_graph_bit_equal_to_jax(kind, requant):
    x = op_inputs(B)
    ref = _jax_run(op_graph(J, kind), x, requant)
    graph = op_graph(P, kind)
    got = _port_run(graph, x, requant=requant)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    plain = _port_run(graph, x, requant=requant, layout_prepasses=False)
    np.testing.assert_array_equal(plain, ref)


def test_prepass_concat_of_fill_fold():
    """The hybrid channel pad (SHAPE -> PACK -> FILL -> CONCATENATION -> 1x1
    CONV_2D) folds into the conv's bias: the CONCATENATION is aliased, the
    FILL not run, and the executor computes fewer steps than the graph has
    ops, with the same outputs."""
    graph = op_graph(P, "shape_pack_fill")
    plan = P.layout_plan(graph)
    names = {i: op.name for i, op in enumerate(graph.ops)}
    assert [names[i] for i in plan.alias_ops] == ["CONCATENATION"]
    assert [names[i] for i in plan.dead_ops] == ["FILL"]
    (n_lead, code), = plan.concat_fold.values()
    assert (n_lead, code) == (4, -3)
    fwd = P.build_executor(graph, B, device="cpu")
    assert fwd.steps == len(graph.ops) - 2
    assert P.build_executor(graph, B, device="cpu", layout_prepasses=False).steps == len(
        graph.ops)


def test_prepass_transpose_elision():
    """TRANSPOSE (0, 2, 1, 3) -> identity STRIDED_SLICE -> CONV_2D: both are
    aliased and the conv applies the perm, with the same outputs."""
    graph = op_graph(P, "transpose_elision")
    plan = P.layout_plan(graph)
    assert sorted(graph.ops[i].name for i in plan.alias_ops) == ["STRIDED_SLICE", "TRANSPOSE"]
    assert set(plan.pending_perm.values()) == {(0, 2, 1, 3)}
    assert P.build_executor(graph, B, device="cpu").steps == len(graph.ops) - 2


def test_prepass_keeps_entry_transpose_chain_unpermuted():
    """Under pretransposed input the chain rooted at the entry TRANSPOSE
    applies no perm (its input arrives transposed): the plan drops them,
    as the JAX executor does."""
    graph = op_graph(P, "transpose_elision")  # starts QUANTIZE -> TRANSPOSE
    assert P.entry_transpose_perm(graph) == (0, 2, 1, 3)
    plan = P.layout_plan(graph, entry_target=graph.ops[1].outputs[0])
    assert 1 not in plan.alias_ops and not plan.pending_perm
    x = op_inputs(B).transpose(0, 2, 1, 3).copy()
    ref = np.asarray(jax.jit(J.build_executor(op_graph(J, "transpose_elision"), B,
                                              pretransposed_input=True))(jnp.asarray(x)))
    got = P.build_executor(graph, B, device="cpu", pretransposed_input=True)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@functools.lru_cache(maxsize=None)
def _flagship_graphs():
    return P.TFLiteGraph(FLAGSHIP_TFLITE), J.TFLiteGraph(str(FLAGSHIP_TFLITE))


def _all_tensors_equal(pgraph, jgraph, x, requant):
    """Every computed tensor of the port's executor equals the jitted JAX
    executor's (return_all); returns the JAX values."""
    ref = jax.jit(J.build_executor(jgraph, x.shape[0], requant=requant, return_all=True))(
        jnp.asarray(x))
    got = P.build_executor(pgraph, x.shape[0], device="cpu", requant=requant,
                           return_all=True)(torch.from_numpy(x))
    computed = [k for k in ref if pgraph.tensors[k].data is None]
    assert computed
    for k in computed:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, np.asarray(ref[k]), err_msg=f"tensor {k} {requant}")
    return {k: np.asarray(ref[k]) for k in computed}


def test_fast_requant_flagship_bit_equal_to_jax():
    """requant='fast' (a plain float32 multiply per channel) equals the JAX
    fast path on every computed tensor of the committed flagship graph;
    most of them differ from the exact path (the final scores need not)."""
    x = flagship_features(2, seed=5)
    pg, jg = _flagship_graphs()
    fast = _all_tensors_equal(pg, jg, x, "fast")
    exact = _all_tensors_equal(pg, jg, x, "exact")
    assert sum(not np.array_equal(fast[k], exact[k]) for k in fast) > len(fast) // 2


@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_fuzz_fixture_executor_bit_equal(i):
    """The nine configurations' graphs on their committed features equal the
    JAX goldens, requant exact and fast, with and without the pre-passes."""
    f = load(i)
    graph = P.TFLiteGraph(f.tflite)
    for requant, ref in (("exact", f.int8_exact), ("fast", f.int8_fast)):
        for pre in (True, False):
            got = _port_run(graph, f.features, requant=requant, layout_prepasses=pre)
            np.testing.assert_array_equal(got, ref, err_msg=f"{f.label} {requant} {pre}")


@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_fuzz_goldens_regenerate(i):
    """Each committed golden equals a fresh jitted JAX executor run on the
    committed graph bytes, so the goldens cannot drift from the JAX package;
    on the way every computed tensor of the port's executor equals JAX's,
    exact and fast (the outputs alone coincide for the two modes here)."""
    f = load(i)
    pgraph, jgraph = P.TFLiteGraph(f.tflite), J.TFLiteGraph(f.tflite)
    for requant, ref in (("exact", f.int8_exact), ("fast", f.int8_fast)):
        vals = _all_tensors_equal(pgraph, jgraph, f.features, requant)
        np.testing.assert_array_equal(vals[jgraph.outputs[0]], ref,
                                      err_msg=f"{f.label} {requant}")
