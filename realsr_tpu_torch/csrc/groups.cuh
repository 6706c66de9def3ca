// Build groups (realsr_tpu_torch/ops/build.py::GROUPS).
//
// A source's instances split by the template parameters other than the
// patch side: the state type (GROUP_F32, GROUP_BF16) and nf/gc (GROUP_NF64
// for 64/32, GROUP_NF32 for 32/16) of the RDB kernels, the form of the tail
// kernel (GROUP_K6 with up2, GROUP_K7 without). nvcc builds one library per
// group with the group's macros; the dispatch functions compile only the
// instances the macros name, and a launch of any other returns
// cudaErrorInvalidValue. An axis none of whose macros is given builds all
// its values, so a source built with no macro holds every instance.
#pragma once

#if !defined(GROUP_F32) && !defined(GROUP_BF16)
#define GROUP_F32
#define GROUP_BF16
#endif
#if !defined(GROUP_NF64) && !defined(GROUP_NF32)
#define GROUP_NF64
#define GROUP_NF32
#endif
#if !defined(GROUP_K6) && !defined(GROUP_K7)
#define GROUP_K6
#define GROUP_K7
#endif
