// Runs K3 (csrc/x_block_fwd.cu) under the CPU emulation of this directory:
//   x_block_harness IN OUT
// IN: 8 int32 (B H W C E k mode dtype), then x and the 13 parameters of
// dat_x_block_fwd, each an int64 byte count (0: none) and its bytes; OUT:
// the output's bytes. Prints the tile rows and the launch's return code.
#include <cstdio>
#include <vector>
#include <cuda_runtime.h>
namespace { alignas(16) unsigned char smem[262144]; }
#include XB_SOURCE  // csrc/x_block_fwd.cu with its cp.async helpers emulated
typedef void (*KFn)(const void*, const void*, const void*, const void*, const void*, const void*,
                    const void*, const void*, const void*, const void*, const void*, const void*,
                    const void*, void*, int, int, int, int, int, int, float);
cudaError_t cudaLaunchKernel(const void* fn, dim3 grid, dim3 block, void** args, size_t smemsz,
                             cudaStream_t) {
  KFn k = (KFn)fn;
  const void* p[13];
  for (int i = 0; i < 13; ++i) p[i] = *(const void**)args[i];
  void* out = *(void**)args[13];
  int iv[6];
  for (int i = 0; i < 6; ++i) iv[i] = *(int*)args[14 + i];
  float eps = *(float*)args[20];
  if (smemsz > sizeof(smem)) { fprintf(stderr, "smem %zu too big\n", smemsz); return 1; }
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        memset(smem, 0xff, smemsz);
        emu_block_bar = EmuBarrier{(int)block.x};
        for (unsigned w = 0; w < block.x / 32; ++w) emu_warp_bar[w] = EmuBarrier{32};
        emu_run_block(block.x, [&](int) {
          k(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], p[12],
            out, iv[0], iv[1], iv[2], iv[3], iv[4], iv[5], eps);
        });
      }
  return 0;
}
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int hdr[8];
  fread(hdr, 4, 8, f);
  const int B = hdr[0], H = hdr[1], W = hdr[2], C = hdr[3], E = hdr[4], k = hdr[5], mode = hdr[6], dt = hdr[7];
  std::vector<std::vector<unsigned char>> arrs(14);
  const void* ptr[14];
  for (int i = 0; i < 14; ++i) {
    long long n;
    fread(&n, 8, 1, f);
    arrs[i].resize(n + 16);
    // 16-byte aligned copy
    unsigned char* base = arrs[i].data();
    unsigned char* al = (unsigned char*)(((uintptr_t)base + 15) & ~(uintptr_t)15);
    fread(al, 1, n, f);
    ptr[i] = n ? al : nullptr;
  }
  fclose(f);
  const size_t nout = (size_t)B * H * W * C * (dt == 0 ? 4 : 2);
  std::vector<unsigned char> outv(nout + 16);
  unsigned char* out = (unsigned char*)(((uintptr_t)outv.data() + 15) & ~(uintptr_t)15);
  memset(out, 0xff, nout);
  printf("tile %d smem %lld\n", dat_x_block_fwd_tile(dt, C, mode, k),
         dat_x_block_fwd_smem_bytes(dt, C, mode, k, dat_x_block_fwd_tile(dt, C, mode, k)));
  int rc = dat_x_block_fwd(ptr[0], ptr[1], ptr[2], ptr[3], ptr[4], ptr[5], ptr[6], ptr[7], ptr[8],
                           ptr[9], ptr[10], ptr[11], ptr[12], out, B, H, W, C, E, k, mode, 1e-5f, dt,
                           nullptr);
  printf("rc %d\n", rc);
  FILE* g = fopen(argv[2], "wb");
  fwrite(out, 1, nout, g);
  fclose(g);
  return rc;
}
