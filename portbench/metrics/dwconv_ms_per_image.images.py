"""Device time of the kernels launched under the CNN forward's depthwise
span (``cnn.dwconv``: each grouped convolution's pad, cuDNN's layout
transposes and the convolution), a traced image.  Nothing to read where
the program opens no depthwise spans."""


def read(run):
    t = run.trace
    if t is None:
        return None
    try:
        from repro_torch.models.layers import DWCONV_SPAN
    except ImportError:
        return None
    if not any(e.name == DWCONV_SPAN for e in t.cpu):
        return None
    images = len(run.traced) * run.units["images"]
    return t.kernel_s_under((DWCONV_SPAN,)) * 1e3 / images
