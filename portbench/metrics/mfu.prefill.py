"""The whole batch's share of the fp32 peak of the cards: the model's
FLOPs a prompt token (the benchmark's count: attention projections, the
two routed experts' SwiGLU and the router, causal scores, the head; not
the dense dispatch's) times the tokens a second of the traced run's
unprofiled batches, over the cards' fp32 peak."""
from portbench import arith


def read(run):
    if run.trace is None:
        return None
    per_token = arith.lm_model_flops_per_token(run.cell.config["model"],
                                               run.cell.traffic["seq"])
    chips = max(1, len(run.trace.devices))
    return 100.0 * per_token * run.rate("tokens", untraced=True) / (
        chips * run.peaks["fp32_flops"])
