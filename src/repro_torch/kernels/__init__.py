"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of
``repro.kernels`` on the ported paths, and two of the CNN forward that
have no TPU counterpart: ``bn_epilogue`` (BatchNorm with the add and
activation after it) and ``dwconv`` (the depthwise convolution, its SAME
padding taken inside the kernel).

Each ``csrc/<name>.cu`` is built by ``_build`` at first use and bound with
ctypes; its wrapper module checks inputs, launches it on the current CUDA
stream and counts launches, and takes the plain version in ``ref.py`` only
for CPU tensors.  ``quant.py`` is the int8 API around ``matmul_qi8``.  The
package re-exports nothing: a kernel module and its function share a name.
"""