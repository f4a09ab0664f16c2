// The C entry points of attn_in.cu (tkq_attn_in) and ffn.cu
// (tkq_oproj_ffn) as layer.cu and rot.cu call them: through the
// addresses their wrappers pass (ops/_build.py:address), so that the
// kernels of those phases are compiled once, in their own libraries, and
// not again inside layer's and rot's (which made those two the build's
// long pole: 82-134 nvcc CPU s each). layer.cu and rot.cu pass every int8
// fold off: the reference's _layer_call (#11) and _rot_call (#12) have no
// int8 branch.
#pragma once

typedef int (*AttnInEntry)(const void* x, const float* nw, float eps, int qk_kind,
                           const void* qk_qs, const void* qk_scl, const void* qk_mins,
                           int v_kind, const void* v_qs, const void* v_scl, const void* v_mins,
                           const float* cosv, const float* sinv, const float* bqk,
                           const float* bv, void* out0, void* out1, int R, int D, int n0, int n1,
                           int hd, int ld0, int ld1, int fold, void* stream);

typedef int (*OprojFfnEntry)(const void* x, const void* attn, const float* nw, float eps,
                             int wo_kind, const void* wo_qs, const void* wo_scl,
                             const void* wo_mins, int gu_kind, const void* gu_qs,
                             const void* gu_scl, const void* gu_mins, int dn_kind,
                             const void* dn_qs, const void* dn_scl, void* x2, void* act,
                             float* ws, void* out, int R, int dim, int K, int F, int cps_o,
                             int splits_o, int cps_g, int splits_g, int cps_d, int splits_d,
                             int gelu, int round_first, int pdl, int fold_wo, int fold_gu,
                             void* stream);
