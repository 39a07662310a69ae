"""Host launch calls made inside the executor's calls, a traced image:
the CUDA runtime and driver events whose names hold ``Launch``
(``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``, ...) whose
``cpu_parent`` chain reaches ``spmd.call``.  Nothing to read where the
program opens no call spans or the trace holds no launch."""


def _under(e, name):
    while e is not None:
        if e.name == name:
            return True
        e = e.cpu_parent
    return False


def read(run):
    t = run.trace
    if t is None:
        return None
    try:
        from repro_torch.launch.pipeline_spmd import CALL_SPAN
    except ImportError:
        return None
    n = sum(1 for e in t.cpu if "Launch" in e.name and _under(e, CALL_SPAN))
    if not n:
        return None
    return n / (len(run.traced) * run.units["images"])
