"""Device time of the kernels launched under the SPMD tier's boundary
span (``spmd.boundary``: each stage's unpack and pack of the flat
boundary buffer, and the call's input pack and output unpack), a traced
image.  Nothing to read where the program opens no boundary spans."""


def read(run):
    t = run.trace
    if t is None:
        return None
    try:
        from repro_torch.launch.pipeline_spmd import BOUNDARY_SPAN
    except ImportError:
        return None
    if not any(e.name == BOUNDARY_SPAN for e in t.cpu):
        return None
    images = len(run.traced) * run.units["images"]
    return t.kernel_s_under((BOUNDARY_SPAN,)) * 1e3 / images
