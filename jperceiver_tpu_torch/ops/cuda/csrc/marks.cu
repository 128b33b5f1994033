// Device phase marks: one empty kernel a mark, named for the phase boundary it marks.
//
// Replaces no TPU kernel. `tracing.py::mark` launches one on the current stream at each
// phase boundary of the entry points: the training step's forward, losses, CGT label, backward
// and update, the eval forward, a streaming chunk. A replay of a CUDA graph runs no host code,
// so no host span can say which of its kernels belong to which phase; a capture records each
// mark as a kernel node, and a profiler trace of any replay shows the marks among the phase's
// kernels, in the order they ran: the device work from one mark to the next is one phase.
// Bound on this card: the launch alone (one block of one thread that does nothing).
//
// Built alone into a library of its own (`_build.py::marks_library`), so that marking a phase
// needs none of the other kernels. This file is the one list of marks: each `JP_MARK(name)`
// gives the kernel `jp_mark_<name>` and its launcher `jp_mark_launch_<name>(stream)`, which
// `tracing.py` looks up by name and which returns the launch's cudaError_t.

#include <cuda_runtime.h>

#define JP_MARK(name)                                                      \
  extern "C" __global__ void jp_mark_##name() {}                           \
  extern "C" int jp_mark_launch_##name(void* stream) {                     \
    jp_mark_##name<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();      \
    return static_cast<int>(cudaGetLastError());                           \
  }

JP_MARK(forward)
JP_MARK(losses)
JP_MARK(cgt)
JP_MARK(backward)
JP_MARK(update)
JP_MARK(end)
JP_MARK(eval)
JP_MARK(chunk)
