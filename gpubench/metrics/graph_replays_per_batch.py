"""CUDA graph replays of the float model per request: the program's
torch.GRAPH spans over the requests (every card's block). The port records
one around each row block that TorchRunner serves by replaying the
block's CUDA graph (birdnet_stm32_tpu_torch/utils/tracing.py; the name is
repeated here because the readers import nothing of the port) and none
around a block served eagerly. So on one card it reads 1 where the graph
engages on every request and 0 where every block ran eagerly, as in a
program without the graph."""

TORCH_GRAPH = "torch.GRAPH"


def read(ctx):
    return sum(s.name == TORCH_GRAPH for s in ctx.trace.spans) / ctx.calls
