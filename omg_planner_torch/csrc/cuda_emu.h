// Test-only CPU emulation of the CUDA subset that the kernels of this
// directory use, so that g++ can compile and run a kernel's own source on
// the host (tests/test_torch_rollout_emu.py,
// tests/test_torch_plan_kernels_emu.py,
// tests/test_torch_learner_kernels_emu.py,
// tests/test_torch_ik_kernels_emu.py, test_torch_ik_kernels_warp_emu.py,
// test_torch_ik_kernels_layout.py, test_torch_chomp_kernels_emu.py).  Never part of a build for the card.
//
//   g++ -std=c++20 -O1 -shared -fPIC -DOMG_CUDA_EMU
//       -x c++ rigid_rollout.cu -o librigid_rollout_emu.so
//
// A launch runs its blocks one after another, each on the calling thread:
// every CUDA thread of the block is a fiber with its own stack, and a small
// scheduler runs the fibers that are not waiting.  On x86-64 a switch
// saves what the SysV ABI asks a callee to keep (rbx, rbp, r12-r15, the
// stack pointer, MXCSR and the x87 control word); elsewhere it is
// ucontext's swapcontext, which also saves the signal mask, one system
// call a switch.
// __syncthreads waits for the whole block, __syncwarp for the warp; a
// block's static __shared__ arrays are one instance that every fiber sees.
// A warp shuffle (xor or broadcast, within the warp or a segment of it),
// vote or warp-wide min or max writes the fiber's value to a per-warp
// slot, waits for the warp and reads its partner's slot (or all 32).
// Two slot buffers alternate, so one wait a shuffle is enough: a fiber
// writes a buffer again only after the whole warp passed the wait of the
// shuffle in between, that is after every read of the earlier one.  One host thread, so the run is the same
// however loaded the machine is, and a barrier that some thread never
// reaches is reported instead of hanging.  Pointers are host pointers
// (CPU tensors).  Every warp-level call must be made by all 32 threads of
// the warp, as the kernel's full-mask calls are.
#pragma once

#include <ucontext.h>

#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

#if defined(__x86_64__)
// omg_emu_switch(save, load): push the callee-saved state, store the stack
// pointer in *save, continue on the stack `load` with the state it holds
extern "C" void omg_emu_switch(void** save, void* load);
__asm__(
    ".text\n"
    ".globl omg_emu_switch\n"
    ".hidden omg_emu_switch\n"
    ".type omg_emu_switch, @function\n"
    "omg_emu_switch:\n"
    "  pushq %rbp\n"
    "  pushq %rbx\n"
    "  pushq %r12\n"
    "  pushq %r13\n"
    "  pushq %r14\n"
    "  pushq %r15\n"
    "  subq $8, %rsp\n"
    "  stmxcsr (%rsp)\n"
    "  fnstcw 4(%rsp)\n"
    "  movq %rsp, (%rdi)\n"
    "  movq %rsi, %rsp\n"
    "  ldmxcsr (%rsp)\n"
    "  fldcw 4(%rsp)\n"
    "  addq $8, %rsp\n"
    "  popq %r15\n"
    "  popq %r14\n"
    "  popq %r13\n"
    "  popq %r12\n"
    "  popq %rbx\n"
    "  popq %rbp\n"
    "  ret\n"
    ".size omg_emu_switch, .-omg_emu_switch\n");
#define OMG_EMU_SWITCH 1
#endif

namespace emu {

constexpr size_t kStack = 1 << 17;  // bytes of stack a fiber

struct Fiber {
#ifdef OMG_EMU_SWITCH
  void* sp = nullptr;  // the saved state's place on the fiber's stack
#else
  ucontext_t ctx;
#endif
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
        uslots(2 * threads),
        smem(smem_bytes / 4 + 4) {
    all.expected = threads;
    for (auto& w : warps) w.expected = 32;
  }
  std::vector<Fiber> fibers;
  Barrier all;
  std::vector<Barrier> warps;
  std::vector<float> slots;  // [2][threads]: shuffle and vote exchange
  std::vector<unsigned> uslots;  // [2][threads]: warp-wide min and max
  std::vector<float> smem;   // the block's dynamic shared memory
  std::deque<Fiber*> ready;
#ifdef OMG_EMU_SWITCH
  void* scheduler = nullptr;
#else
  ucontext_t scheduler;
#endif
  Fiber* current = nullptr;
  std::function<void()> body;
};

inline Block* block = nullptr;

inline float* dynamic_smem() { return block->smem.data(); }

// The running fiber gives the host thread back to the scheduler.
inline void to_scheduler(Fiber* me) {
#ifdef OMG_EMU_SWITCH
  omg_emu_switch(&me->sp, block->scheduler);
#else
  swapcontext(&me->ctx, &block->scheduler);
#endif
}

// The scheduler runs f until it waits or ends.
inline void run_fiber(Block& blk, Fiber* f) {
#ifdef OMG_EMU_SWITCH
  omg_emu_switch(&blk.scheduler, f->sp);
#else
  swapcontext(&blk.scheduler, &f->ctx);
#endif
}

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
  to_scheduler(me);
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

// Publish v, meet the warp, return the warp's 32 values folded by f.
template <class F>
inline unsigned fold(unsigned v, F f) {
  Fiber* me = block->current;
  const unsigned t = me->tid;
  unsigned* buf =
      block->uslots.data() + (me->turn ^= 1) * block->fibers.size();
  buf[t] = v;
  wait_at(my_warp());
  unsigned r = buf[t & ~31u];
  for (unsigned l = 1; l < 32; ++l) r = f(r, buf[(t & ~31u) | l]);
  return r;
}

inline void fiber_main() {
  block->body();
  block->current->done = true;
#ifdef OMG_EMU_SWITCH
  to_scheduler(block->current);  // never resumed
  __builtin_unreachable();
#endif
}  // with ucontext, returning resumes the scheduler (uc_link)

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

// lane l's bit set where pred is true in lane l
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned bit = (pred ? 1u : 0u) << (threadIdx.x & 31);
  return emu::fold(bit, [](unsigned a, unsigned b) { return a | b; });
}

// the value of lane (lane - delta), or the caller's own below lane delta
inline int __shfl_up_sync(unsigned, int v, unsigned delta) {
  emu::Fiber* me = emu::block->current;
  const unsigned t = me->tid;
  unsigned* buf = emu::block->uslots.data() +
                  (me->turn ^= 1) * emu::block->fibers.size();
  buf[t] = static_cast<unsigned>(v);
  emu::wait_at(emu::my_warp());
  const unsigned lane = t & 31u;
  return lane < delta ? v : static_cast<int>(buf[t - delta]);
}

inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return emu::fold(v, [](unsigned a, unsigned b) { return a > b ? a : b; });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu::fold(v, [](unsigned a, unsigned b) { return a < b ? a : b; });
}

inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

// round-to-nearest products and sums that are never contracted (g++
// contracts no multiply-add into an FMA for x86-64 without -mfma)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
// a fused multiply-add, rounded once (libm's fmaf)
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }

// the pipeline primitives (cp.async): the copy happens at once, so the
// waits have nothing to wait for
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + (size - zfill), 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

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
#ifdef OMG_EMU_SWITCH
  // the state omg_emu_switch pops, below a 16-byte aligned top: MXCSR and
  // the x87 control word at their defaults, six registers, then
  // fiber_main as the return address, entered as if called
  const uintptr_t top =
      (reinterpret_cast<uintptr_t>(f.stack.get()) + kStack) & ~uintptr_t{15};
  uint64_t* sp = reinterpret_cast<uint64_t*>(top - 72);
  const uint32_t mxcsr = 0x1f80;
  const uint16_t fpucw = 0x037f;
  std::memset(sp, 0, 72);
  std::memcpy(sp, &mxcsr, sizeof mxcsr);
  std::memcpy(reinterpret_cast<char*>(sp) + 4, &fpucw, sizeof fpucw);
  sp[7] = reinterpret_cast<uint64_t>(&fiber_main);
  f.sp = sp;
#else
  getcontext(&f.ctx);
  f.ctx.uc_stack.ss_sp = f.stack.get();
  f.ctx.uc_stack.ss_size = kStack;
  f.ctx.uc_link = &blk.scheduler;
  makecontext(&f.ctx, fiber_main, 0);
#endif
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
      run_fiber(blk, f);
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
