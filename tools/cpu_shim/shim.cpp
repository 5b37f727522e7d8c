#include "cuda_runtime.h"
#include <cstdio>
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local ShimBlock* shim_blk;
thread_local int shim_tid;
char* shim_dyn_smem;
int shim_last_error = 0;
static std::vector<char> dyn(1 << 20);
void shim_launch(dim3 g, dim3 b, size_t smem, std::function<void()> body) {
  gridDim = g; blockDim = b;
  if (smem > dyn.size()) dyn.resize(smem);
  const int nt = b.x * b.y * b.z;
  for (unsigned bz = 0; bz < g.z; ++bz) for (unsigned by = 0; by < g.y; ++by) for (unsigned bx = 0; bx < g.x; ++bx) {
    std::memset(dyn.data(), 0xCD, dyn.size());
    shim_dyn_smem = dyn.data();
    ShimBlock blk;
    blk.nthreads = nt;
    blk.bar = std::make_unique<std::barrier<>>(nt);
    for (int w = 0; w < (nt + 31) / 32; ++w) blk.wbar.push_back(std::make_unique<std::barrier<>>(std::min(32, nt - 32 * w)));
    blk.xch.assign(nt, 0);
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) ts.emplace_back([&, t] {
      shim_blk = &blk; shim_tid = t;
      threadIdx = dim3(t % b.x, (t / b.x) % b.y, t / (b.x * b.y));
      blockIdx = dim3(bx, by, bz);
      body();
      blk.wbar[t / 32]->arrive_and_drop();
      blk.bar->arrive_and_drop();
    });
    for (auto& t : ts) t.join();
  }
}
