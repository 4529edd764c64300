// Mailbox memory for the processes of a mesh: device regions that other
// processes map through CUDA IPC, and 64-bit words that streams write and
// wait on with libcuda's stream memory operations, so that a message
// moves from one process's device buffer into another's, ordered on the two
// processes' streams, with no host copy and no host wait.
//
// This is the port's counterpart of the collectives that
// lqr_tpu/parallel/sharding.py compiles into its program (the `ppermute`s
// of each row block's halo plane and of the compaction's carry column, the
// `all_gather`s of the backtrack's inputs and the commit's row counts).
// There is no kernel here: a message is one cudaMemcpyAsync into the
// receiver's slot and one cuStreamWriteValue64 of its sequence number into
// the receiver's flag; the protocol (rings of slots, flags, credits) is
// parallel/mailbox.py's.
//
// Ordering: cuStreamWriteValue64 with its default flags is preceded by a
// memory barrier, so the payload copied before it on the same stream is
// visible before the flag; cuStreamWaitValue64 (>=) holds the stream's
// later work until the word reaches the value. Regions come from
// cudaMalloc, not from PyTorch's caching allocator: an IPC handle covers a
// whole allocation, and the allocator hands out offsets inside its
// segments. libcuda's functions are looked up through the runtime
// (cudaGetDriverEntryPoint), so the library links without -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

using StreamValue64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t,
                                   unsigned int);

template <class F>
cudaError_t cu_fn(const char* name, F* fn) {
  if (*fn != nullptr) return cudaSuccess;
  void* f = nullptr;
  const cudaError_t err = cudaGetDriverEntryPoint(name, &f, cudaEnableDefault);
  if (err != cudaSuccess || f == nullptr) {
    cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorNotSupported;
  }
  *fn = reinterpret_cast<F>(f);
  return cudaSuccess;
}

StreamValue64 write_fn = nullptr;
StreamValue64 wait_fn = nullptr;

// A CUresult as the int the wrappers check (CUresult and cudaError_t
// agree where both name an error, e.g. 801, not supported).
int cu_result(CUresult r) { return (int)r; }

}  // namespace

extern "C" {

// A zeroed region of `bytes` on the current device, from cudaMalloc.
int lqr_mb_alloc(size_t bytes, void** out) {
  void* p = nullptr;
  cudaError_t err = cudaMalloc(&p, bytes);
  if (err == cudaSuccess) err = cudaMemset(p, 0, bytes);
  if (err != cudaSuccess) {
    if (p != nullptr) cudaFree(p);
    cudaGetLastError();
    return (int)err;
  }
  *out = p;
  return 0;
}

int lqr_mb_free(void* p) { return (int)cudaFree(p); }

// The region's IPC handle, sizeof(cudaIpcMemHandle_t) = 64 bytes into out.
int lqr_mb_handle(void* p, void* out) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, p);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  std::memcpy(out, &h, sizeof(h));
  return 0;
}

// Another process's region, mapped into this one from its handle.
int lqr_mb_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  const cudaError_t err =
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

int lqr_mb_close(void* p) { return (int)cudaIpcCloseMemHandle(p); }

// On `stream`: write `value` to the 8-byte word at `word` (a memory
// barrier first).
int lqr_mb_write(void* word, uint64_t value, void* stream) {
  const cudaError_t err = cu_fn("cuStreamWriteValue64", &write_fn);
  if (err != cudaSuccess) return (int)err;
  return cu_result(write_fn((CUstream)stream, (CUdeviceptr)word, value,
                            CU_STREAM_WRITE_VALUE_DEFAULT));
}

// On `stream`: hold the stream's later work until the 8-byte word at
// `word` is >= value.
int lqr_mb_wait(void* word, uint64_t value, void* stream) {
  const cudaError_t err = cu_fn("cuStreamWaitValue64", &wait_fn);
  if (err != cudaSuccess) return (int)err;
  return cu_result(wait_fn((CUstream)stream, (CUdeviceptr)word, value,
                           CU_STREAM_WAIT_VALUE_GEQ));
}

// One message on `stream`: wait until the credit word (in this process's
// memory) is >= `credit` (skipped when `credit_word` is null), copy `bytes`
// from src into the slot dst (the receiver's memory), then write `value`
// into the receiver's flag.
int lqr_mb_put(void* credit_word, uint64_t credit, void* dst, const void* src,
               size_t bytes, void* flag, uint64_t value, void* stream) {
  int rc = 0;
  if (credit_word != nullptr) rc = lqr_mb_wait(credit_word, credit, stream);
  if (rc != 0) return rc;
  const cudaError_t err = cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault,
                                          (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return lqr_mb_write(flag, value, stream);
}

}  // extern "C"
