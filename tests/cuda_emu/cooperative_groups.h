// The part of CUDA's cooperative groups the port's kernels use, for the
// host emulation of cuda_runtime.h beside this file: the thread-block
// cluster of the calling thread, its barrier over every thread of the
// cluster, the block's rank, and a pointer into another block's dynamic
// shared memory at the same offset.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { emu::cluster->meet.wait(emu::cluster->threads); }
  unsigned block_rank() const { return emu::cluster_rank; }
  unsigned num_blocks() const {
    return (unsigned)emu::cluster->blocks.size();
  }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const std::ptrdiff_t off =
        reinterpret_cast<unsigned char*>(p) - emu::block->base();
    return reinterpret_cast<T*>(emu::cluster->blocks[rank]->base() + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
