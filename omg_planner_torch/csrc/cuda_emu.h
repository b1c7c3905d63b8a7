// Test-only CPU emulation of the CUDA subset that the kernels of this
// directory use, so that g++ can compile and run a kernel's own source on
// the host (tests/test_torch_rollout_emu.py,
// tests/test_torch_plan_kernels_emu.py).  Never part of a build for the
// card.
//
//   g++ -std=c++20 -O1 -shared -fPIC -DOMG_CUDA_EMU
//       -x c++ rigid_rollout.cu -o librigid_rollout_emu.so
//
// A launch runs its blocks one after another, each on the calling thread:
// every CUDA thread of the block is a fiber (ucontext) with its own stack,
// and a small scheduler runs the fibers that are not waiting.
// __syncthreads waits for the whole block, __syncwarp for the warp; a
// block's static __shared__ arrays are one instance that every fiber sees.
// A warp shuffle (xor or broadcast, within the warp or a segment of it) or
// vote writes the fiber's value to a per-warp slot, waits for
// the warp and reads its partner's slot.  Two slot buffers alternate, so
// one wait a shuffle is enough: a fiber writes a buffer again only after
// the whole warp passed the wait of the shuffle in between, that is after
// every read of the earlier one.  One host thread, so the run is the same
// however loaded the machine is, and a barrier that some thread never
// reaches is reported instead of hanging.  Pointers are host pointers
// (CPU tensors).  Every warp-level call must be made by all 32 threads of
// the warp, as the kernel's full-mask calls are.
#pragma once

#include <ucontext.h>

#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
// a block's static shared memory: one instance for every fiber (blocks run
// one after another, and a kernel never reads what it did not write)
#define __shared__ static

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

// the running fiber's coordinates (one block runs at a time)
inline dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {

constexpr size_t kStack = 1 << 17;  // bytes of stack a fiber

struct Fiber {
  ucontext_t ctx;
  unsigned tid = 0;
  int turn = 0;  // which slot buffer the fiber's next exchange uses
  bool done = false;
  std::unique_ptr<char[]> stack;
};

struct Barrier {
  int expected = 0, count = 0;
  std::vector<Fiber*> waiting;
};

struct Block {
  Block(int threads, size_t smem_bytes)
      : fibers(threads), warps(threads / 32), slots(2 * threads),
        smem(smem_bytes / 4 + 4) {
    all.expected = threads;
    for (auto& w : warps) w.expected = 32;
  }
  std::vector<Fiber> fibers;
  Barrier all;
  std::vector<Barrier> warps;
  std::vector<float> slots;  // [2][threads]: shuffle and vote exchange
  std::vector<float> smem;   // the block's dynamic shared memory
  std::deque<Fiber*> ready;
  ucontext_t scheduler;
  Fiber* current = nullptr;
  std::function<void()> body;
};

inline Block* block = nullptr;

inline float* dynamic_smem() { return block->smem.data(); }

// The current fiber arrives at b: the last arrival releases the others and
// runs on; any other waits in the scheduler.
inline void wait_at(Barrier& b) {
  Fiber* me = block->current;
  if (++b.count == b.expected) {
    b.count = 0;
    for (Fiber* f : b.waiting) block->ready.push_back(f);
    b.waiting.clear();
    return;
  }
  b.waiting.push_back(me);
  swapcontext(&me->ctx, &block->scheduler);
}

inline Barrier& my_warp() { return block->warps[threadIdx.x >> 5]; }

// Publish v, meet the warp, return the slot of ``lane`` in this warp.
inline float exchange(float v, int lane) {
  Fiber* me = block->current;
  const unsigned t = me->tid;
  float* buf = block->slots.data() + (me->turn ^= 1) * block->fibers.size();
  buf[t] = v;
  wait_at(my_warp());
  return buf[(t & ~31u) | static_cast<unsigned>(lane)];
}

inline void fiber_main() {
  block->body();
  block->current->done = true;
}  // returning resumes the scheduler (uc_link)

}  // namespace emu

inline void __syncthreads() { emu::wait_at(emu::block->all); }

inline void __syncwarp(unsigned = 0xffffffffu) { emu::wait_at(emu::my_warp()); }

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return emu::exchange(v, static_cast<int>(threadIdx.x & 31) ^ mask);
}

// lane src of the caller's segment of ``width`` lanes (a power of two)
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  return emu::exchange(v, (lane & ~(width - 1)) | (src & (width - 1)));
}

inline int __any_sync(unsigned, int pred) {
  emu::Fiber* me = emu::block->current;
  const unsigned t = me->tid;
  float* buf = emu::block->slots.data() +
               (me->turn ^= 1) * emu::block->fibers.size();
  buf[t] = pred ? 1.f : 0.f;
  emu::wait_at(emu::my_warp());
  int any = 0;
  for (unsigned l = 0; l < 32; ++l) any |= buf[(t & ~31u) | l] != 0.f;
  return any;
}

// round-to-nearest products and sums that are never contracted (g++
// contracts no multiply-add into an FMA for x86-64 without -mfma)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}

inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

namespace emu {

// Give fiber t of blk its stack and its entry, and queue it.
inline __attribute__((noinline)) void start_fiber(Block& blk, int t) {
  Fiber& f = blk.fibers[t];
  f.tid = static_cast<unsigned>(t);
  f.stack.reset(new char[kStack]);
  getcontext(&f.ctx);
  f.ctx.uc_stack.ss_sp = f.stack.get();
  f.ctx.uc_stack.ss_size = kStack;
  f.ctx.uc_link = &blk.scheduler;
  makecontext(&f.ctx, fiber_main, 0);
  blk.ready.push_back(&f);
}

// kernel<<<blocks, threads, smem>>>(args...), one block after another.
template <class... A, class... B>
void launch(void (*kernel)(A...), int blocks, int threads, size_t smem,
            B&&... args) {
  for (int b = 0; b < blocks; ++b) {
    Block blk(threads, smem);
    block = &blk;
    blk.body = [&] { kernel(args...); };
    blockIdx.x = b;
    blockDim.x = threads;
    gridDim.x = blocks;
    for (int t = 0; t < threads; ++t) start_fiber(blk, t);
    while (!blk.ready.empty()) {
      Fiber* f = blk.ready.front();
      blk.ready.pop_front();
      blk.current = f;
      threadIdx.x = f->tid;
      // back here when f waits at a barrier or returns from the kernel
      swapcontext(&blk.scheduler, &f->ctx);
    }
    int finished = 0;
    for (const Fiber& f : blk.fibers) finished += f.done;
    if (finished != threads) {
      std::fprintf(stderr, "cuda_emu: block %d deadlocked at a barrier\n", b);
      std::abort();
    }
  }
  block = nullptr;
}

}  // namespace emu
