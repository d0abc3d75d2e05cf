"""route_ms: milliseconds a batch in the engine's routing step
(``search/serve.py::_probe_rank``), timed through the public
``ServingEngine.probe_order`` (routing and the [m, nprobes] read-back) with
CUDA events around the first ``BATCHES`` pool batches, after one warm call:
``cli/serve_tail_profile.py::decompose``'s method. Moves ``qps``."""

import torch

BATCHES = 64


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    cfg = ctx.config
    batches = [ctx.pool[i] for i in range(min(BATCHES, ctx.pool.shape[0]))]

    def route(q):
        ctx.engine.probe_order(q, cfg["nprobes"], voting_t=cfg["voting_t"],
                               rule=cfg["rule"])

    route(batches[0])
    torch.cuda.synchronize(ctx.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for q in batches:
        route(q)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(batches)
