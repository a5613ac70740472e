// The rule menu of K2's in-kernel fragment rhs (frag=), shared by K2
// (tcec_matmul_k2.cu) and the non-finite fix-up (nonfinite_fixup.cuh).
//
// Replaces: the foreach_ij rule that repro/kernels/tcec_matmul.py::
// _fused_kernel evaluates at each (k, n) of an rhs block (the paper's Code
// 4/5).  A library built ahead of time cannot compile a Python rule, so the
// kernel takes a rule id and two integer arguments, as K8 takes (gi, gj):
// repro_torch/tcec/operands.py::MenuRule, whose call is the plain version
// of band() below.  Every rule takes only the values 0 and 1,
// exact in one bf16 word, and is finite.
//
// Every rule of the menu is 1 on a band of diagonals, lo <= n - k <= hi, and
// 0 elsewhere, so a kernel turns the rule into its band once and tests a
// diagonal index per value.
#pragma once

#include <climits>

namespace menu {

enum RuleId { NONE = -1, TRIANGULAR = 0, IDENTITY = 1, BANDED = 2 };

// A rule of the menu with its arguments: TRIANGULAR (p0 upper, p1 strict),
// IDENTITY, BANDED (p0 k_low, p1 k_up).  NONE: no rule.
struct Spec {
  int id, p0, p1;
};

// The diagonals lo <= n - k <= hi on which a rule is 1 (empty if lo > hi).
struct Band {
  int lo, hi;
  __host__ __device__ __forceinline__ bool holds(int d) const { return lo <= d && d <= hi; }
};

__host__ __device__ __forceinline__ Band band(const Spec& r) {
  switch (r.id) {
    case TRIANGULAR:
      return r.p0 ? Band{r.p1 ? 1 : 0, INT_MAX} : Band{INT_MIN, r.p1 ? -1 : 0};
    case IDENTITY: return Band{0, 0};
    case BANDED: return Band{-r.p0, r.p1};  // j - i <= k_up and i - j <= k_low
    default: return Band{1, 0};
  }
}

// The rule's value at row k, column n of the (K, N) rhs.
__host__ __device__ __forceinline__ float rule_at(const Spec& r, int k, int n) {
  return band(r).holds(n - k) ? 1.f : 0.f;
}

}  // namespace menu
