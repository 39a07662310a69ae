"""The whole batch's share of the fp32 peak: ResNet50's model FLOPs an
image (the benchmark's count: convolutions and the dense layer) times the
images a second of the traced run's unprofiled batches, over the card's
fp32 peak."""


def read(run):
    if run.trace is None:
        return None
    flops = run.cell.reference.model_flops_per_image(
        run.cell.config["model"])
    chips = max(1, len(run.trace.devices))
    return 100.0 * flops * run.rate("images", untraced=True) / (
        chips * run.peaks["fp32_flops"])
