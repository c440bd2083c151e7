// Native graph-preprocessing core (C++17 + OpenMP).
//
// Device-side compute lives in XLA; this library is the host runtime's
// native half — the counterpart of the reference's C++ graph machinery
// (src/common/graph.cc: orientation :233-279, sort :138-146, edge list
// :297-326; include/scan.h parallel_prefix_sum). It handles the
// preprocessing that would otherwise bottleneck large-graph loading in
// numpy: DAG orientation, degree relabeling, neighbor sorting, COO
// materialisation. Exposed via a C ABI for ctypes (no pybind11 in the
// image).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

using i64 = int64_t;
using i32 = int32_t;

namespace {

// blocked parallel prefix sum over counts[0..n) -> out[0..n]
void prefix_sum(const i64* counts, i64 n, i64* out) {
  out[0] = 0;
  for (i64 i = 0; i < n; ++i) out[i + 1] = out[i] + counts[i];
}

}  // namespace

extern "C" {

// Keep edges (u,v) with (deg[v],v) > (deg[u],u); rebuild CSR.
// out_colidx must have room for E/2 entries (symmetric input).
// Returns the number of kept edges.
i64 gm_orient(i64 V, i64 E, const i64* rowptr, const i32* colidx,
              i64* out_rowptr, i32* out_colidx) {
  std::vector<i64> deg(V), keep(V, 0);
#pragma omp parallel for schedule(static)
  for (i64 v = 0; v < V; ++v) deg[v] = rowptr[v + 1] - rowptr[v];

#pragma omp parallel for schedule(dynamic, 1024)
  for (i64 u = 0; u < V; ++u) {
    i64 c = 0;
    for (i64 e = rowptr[u]; e < rowptr[u + 1]; ++e) {
      i32 v = colidx[e];
      if (deg[v] > deg[u] || (deg[v] == deg[u] && v > u)) ++c;
    }
    keep[u] = c;
  }
  prefix_sum(keep.data(), V, out_rowptr);
#pragma omp parallel for schedule(dynamic, 1024)
  for (i64 u = 0; u < V; ++u) {
    i64 o = out_rowptr[u];
    for (i64 e = rowptr[u]; e < rowptr[u + 1]; ++e) {
      i32 v = colidx[e];
      if (deg[v] > deg[u] || (deg[v] == deg[u] && v > u)) out_colidx[o++] = v;
    }
  }
  return out_rowptr[V];
}

// Renumber vertices by (degree, id) ascending (descending = reversed) and
// rebuild a sorted CSR. perm[new_id] = old_id; inv[old_id] = new_id.
void gm_relabel_by_degree(i64 V, i64 E, const i64* rowptr, const i32* colidx,
                          int descending, i64* out_rowptr, i32* out_colidx,
                          i32* perm, i32* inv) {
  std::vector<std::pair<i64, i32>> key(V);
#pragma omp parallel for schedule(static)
  for (i64 v = 0; v < V; ++v)
    key[v] = {rowptr[v + 1] - rowptr[v], (i32)v};
  if (descending)
    std::sort(key.begin(), key.end(), [](auto& a, auto& b) {
      return a.first != b.first ? a.first > b.first : a.second < b.second;
    });
  else
    std::sort(key.begin(), key.end());
#pragma omp parallel for schedule(static)
  for (i64 i = 0; i < V; ++i) {
    perm[i] = key[i].second;
    inv[key[i].second] = (i32)i;
  }
  std::vector<i64> counts(V);
#pragma omp parallel for schedule(static)
  for (i64 i = 0; i < V; ++i)
    counts[i] = rowptr[perm[i] + 1] - rowptr[perm[i]];
  prefix_sum(counts.data(), V, out_rowptr);
#pragma omp parallel for schedule(dynamic, 1024)
  for (i64 i = 0; i < V; ++i) {
    i64 o = out_rowptr[i];
    i32 old = perm[i];
    for (i64 e = rowptr[old]; e < rowptr[old + 1]; ++e)
      out_colidx[o++] = inv[colidx[e]];
    std::sort(out_colidx + out_rowptr[i], out_colidx + out_rowptr[i + 1]);
  }
}

// In-place ascending sort of every adjacency list.
void gm_sort_neighbors(i64 V, const i64* rowptr, i32* colidx) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (i64 v = 0; v < V; ++v)
    std::sort(colidx + rowptr[v], colidx + rowptr[v + 1]);
}

// Materialize COO (src,dst) from CSR; sym_break keeps src>dst (descend) or
// src<dst (ascend). Returns number of tasks written.
i64 gm_edge_list(i64 V, i64 E, const i64* rowptr, const i32* colidx,
                 int sym_break, int ascend, i32* src, i32* dst) {
  if (!sym_break) {
#pragma omp parallel for schedule(dynamic, 1024)
    for (i64 u = 0; u < V; ++u)
      for (i64 e = rowptr[u]; e < rowptr[u + 1]; ++e) {
        src[e] = (i32)u;
        dst[e] = colidx[e];
      }
    return E;
  }
  std::vector<i64> keep(V);
#pragma omp parallel for schedule(dynamic, 1024)
  for (i64 u = 0; u < V; ++u) {
    i64 c = 0;
    for (i64 e = rowptr[u]; e < rowptr[u + 1]; ++e) {
      i32 v = colidx[e];
      if (ascend ? ((i64)v > u) : ((i64)v < u)) ++c;
    }
    keep[u] = c;
  }
  std::vector<i64> offs(V + 1);
  prefix_sum(keep.data(), V, offs.data());
#pragma omp parallel for schedule(dynamic, 1024)
  for (i64 u = 0; u < V; ++u) {
    i64 o = offs[u];
    for (i64 e = rowptr[u]; e < rowptr[u + 1]; ++e) {
      i32 v = colidx[e];
      if (ascend ? ((i64)v > u) : ((i64)v < u)) {
        src[o] = (i32)u;
        dst[o] = v;
        ++o;
      }
    }
  }
  return offs[V];
}

// Build a sorted, dedup'd CSR from a COO edge list — the counterpart of the
// reference's graph converter (src/common/graph.cc:4-124 ingestion side).
// symmetrize != 0 adds both directions and drops self loops. out_colidx
// needs capacity E (or 2E when symmetrize). Returns the final edge count.
i64 gm_csr_from_coo(i64 V, i64 E, const i32* src, const i32* dst,
                    int symmetrize, i64* out_rowptr, i32* out_colidx) {
  std::vector<i64> counts(V, 0);
#pragma omp parallel for schedule(static)
  for (i64 e = 0; e < E; ++e) {
    i32 u = src[e], v = dst[e];
    if (symmetrize && u == v) continue;
#pragma omp atomic
    ++counts[u];
    if (symmetrize) {
#pragma omp atomic
      ++counts[v];
    }
  }
  std::vector<i64> offs(V + 1);
  prefix_sum(counts.data(), V, offs.data());
  std::vector<i64> cursor(offs.begin(), offs.end() - 1);
  const i64 cap = offs[V];
  std::vector<i32> tmp(cap);
#pragma omp parallel for schedule(static)
  for (i64 e = 0; e < E; ++e) {
    i32 u = src[e], v = dst[e];
    if (symmetrize && u == v) continue;
    i64 o;
#pragma omp atomic capture
    o = cursor[u]++;
    tmp[o] = v;
    if (symmetrize) {
#pragma omp atomic capture
      o = cursor[v]++;
      tmp[o] = u;
    }
  }
  // per-row sort + dedup, then compact
  std::vector<i64> newlen(V);
#pragma omp parallel for schedule(dynamic, 1024)
  for (i64 u = 0; u < V; ++u) {
    i32* b = tmp.data() + offs[u];
    i32* e = tmp.data() + offs[u + 1];
    std::sort(b, e);
    newlen[u] = std::unique(b, e) - b;
  }
  prefix_sum(newlen.data(), V, out_rowptr);
#pragma omp parallel for schedule(dynamic, 1024)
  for (i64 u = 0; u < V; ++u)
    std::memcpy(out_colidx + out_rowptr[u], tmp.data() + offs[u],
                newlen[u] * sizeof(i32));
  return out_rowptr[V];
}

// Streamed set-bit expansion for the big-clique engine
// (graphminer_tpu/ops/cliquebig.py). For each task t in [start, n_tasks):
//   w = bases[0][rows[0][t]] & … & bases[n_src-1][rows[n_src-1][t]]
//       (bitmap rows of `words` uint32 each)
// emit (t, bit_pos) for every set bit of w with bit_pos < n_bits.
// Stops BEFORE the first task that would overflow `cap` emissions;
// *next_start = first unprocessed task; returns #emitted. Two-pass per
// block (parallel popcount, serial prefix, parallel emit) so output order
// is deterministic task-major / bit-ascending — the contract the hi/lo
// split's ascending-prefix argument relies on.
//
// This replaces a numpy unpackbits+nonzero pipeline that touched ~20x the
// bytes (bit->byte expansion) single-threaded; with ctz enumeration the
// cost is reads (2-4 rows/task) + one write per emission, OpenMP-parallel.
i64 gm_expand_multi(i64 n_tasks, i64 start, i64 words, i64 n_bits,
                    i64 n_src, const uint32_t* const* bases,
                    const i64* const* rows, i64 cap,
                    i64* out_task, i32* out_bit, i64* next_start) {
  const i64 BLK = 1 << 20;
  i64 emitted = 0;
  i64 t = start;
  std::vector<i64> cnt(BLK);
  std::vector<i64> off(BLK + 1);
  const i64 full_words = n_bits / 32;
  const uint32_t tail_mask =
      (n_bits % 32) ? ((uint32_t{1} << (n_bits % 32)) - 1) : 0;
  while (t < n_tasks) {
    const i64 b_end = std::min(n_tasks, t + BLK);
    const i64 nb = b_end - t;
#pragma omp parallel for schedule(static)
    for (i64 i = 0; i < nb; ++i) {
      const i64 task = t + i;
      i64 c = 0;
      for (i64 w = 0; w < words; ++w) {
        if (w > full_words) break;
        uint32_t x = bases[0][rows[0][task] * words + w];
        for (i64 s = 1; s < n_src; ++s)
          x &= bases[s][rows[s][task] * words + w];
        if (w == full_words) x &= tail_mask;
        c += __builtin_popcount(x);
      }
      cnt[i] = c;
    }
    prefix_sum(cnt.data(), nb, off.data());
    // how many whole tasks fit in the remaining cap?
    i64 fit = nb;
    if (emitted + off[nb] > cap) {
      fit = 0;
      while (fit < nb && emitted + off[fit + 1] <= cap) ++fit;
      if (fit == 0) break;  // cap too small for the next task
    }
#pragma omp parallel for schedule(static)
    for (i64 i = 0; i < fit; ++i) {
      const i64 task = t + i;
      i64 o = emitted + off[i];
      for (i64 w = 0; w < words; ++w) {
        if (w > full_words) break;
        uint32_t x = bases[0][rows[0][task] * words + w];
        for (i64 s = 1; s < n_src; ++s)
          x &= bases[s][rows[s][task] * words + w];
        if (w == full_words) x &= tail_mask;
        while (x) {
          const int b = __builtin_ctz(x);
          out_task[o] = task;
          out_bit[o] = (i32)(w * 32 + b);
          ++o;
          x &= x - 1;
        }
      }
    }
    emitted += off[fit];
    t += fit;
    if (fit < nb) break;  // cap reached mid-block
  }
  *next_start = t;
  return emitted;
}

// State-carrying variant: emits, for every set bit, the task's n_attr
// attribute columns followed by the bit position — i.e. the NEXT level's
// packed [n_em, n_attr+1] int32 state matrix, assembled in parallel in one
// pass (the python-side gather/concatenate assembly measured ~20x the
// bytes and ran single-threaded). rows are int32 per-task row indices.
i64 gm_expand_emit(i64 n_tasks, i64 start, i64 words, i64 n_bits,
                   i64 n_src, const uint32_t* const* bases,
                   const i32* const* rows,
                   i64 n_attr, const i32* const* attrs,
                   i64 cap, i32* out, i64* next_start) {
  const i64 BLK = 1 << 20;
  const i64 ncol = n_attr + 1;
  i64 emitted = 0;
  i64 t = start;
  std::vector<i64> cnt(BLK);
  std::vector<i64> off(BLK + 1);
  const i64 full_words = n_bits / 32;
  const uint32_t tail_mask =
      (n_bits % 32) ? ((uint32_t{1} << (n_bits % 32)) - 1) : 0;
  while (t < n_tasks) {
    const i64 b_end = std::min(n_tasks, t + BLK);
    const i64 nb = b_end - t;
#pragma omp parallel for schedule(static)
    for (i64 i = 0; i < nb; ++i) {
      const i64 task = t + i;
      i64 c = 0;
      for (i64 w = 0; w < words; ++w) {
        if (w > full_words) break;
        uint32_t x = bases[0][(i64)rows[0][task] * words + w];
        for (i64 s = 1; s < n_src; ++s)
          x &= bases[s][(i64)rows[s][task] * words + w];
        if (w == full_words) x &= tail_mask;
        c += __builtin_popcount(x);
      }
      cnt[i] = c;
    }
    prefix_sum(cnt.data(), nb, off.data());
    i64 fit = nb;
    if (emitted + off[nb] > cap) {
      fit = 0;
      while (fit < nb && emitted + off[fit + 1] <= cap) ++fit;
      if (fit == 0) break;
    }
#pragma omp parallel for schedule(static)
    for (i64 i = 0; i < fit; ++i) {
      const i64 task = t + i;
      i64 o = emitted + off[i];
      for (i64 w = 0; w < words; ++w) {
        if (w > full_words) break;
        uint32_t x = bases[0][(i64)rows[0][task] * words + w];
        for (i64 s = 1; s < n_src; ++s)
          x &= bases[s][(i64)rows[s][task] * words + w];
        if (w == full_words) x &= tail_mask;
        while (x) {
          const int b = __builtin_ctz(x);
          i32* row_out = out + o * ncol;
          for (i64 a = 0; a < n_attr; ++a) row_out[a] = attrs[a][task];
          row_out[n_attr] = (i32)(w * 32 + b);
          ++o;
          x &= x - 1;
        }
      }
    }
    emitted += off[fit];
    t += fit;
    if (fit < nb) break;
  }
  *next_start = t;
  return emitted;
}

// Popcount-only prepass: out_counts[t] = |AND of the task's bitmap rows|
// below n_bits. Used to pick device-dispatch chunk boundaries with exact
// expansion quotas (no trial-and-error capacity).
void gm_count_multi(i64 n_tasks, i64 words, i64 n_bits, i64 n_src,
                    const uint32_t* const* bases, const i32* const* rows,
                    i32* out_counts) {
  const i64 full_words = n_bits / 32;
  const uint32_t tail_mask =
      (n_bits % 32) ? ((uint32_t{1} << (n_bits % 32)) - 1) : 0;
#pragma omp parallel for schedule(static)
  for (i64 t = 0; t < n_tasks; ++t) {
    i64 c = 0;
    for (i64 w = 0; w < words; ++w) {
      if (w > full_words) break;
      uint32_t x = bases[0][(i64)rows[0][t] * words + w];
      for (i64 s = 1; s < n_src; ++s)
        x &= bases[s][(i64)rows[s][t] * words + w];
      if (w == full_words) x &= tail_mask;
      c += __builtin_popcount(x);
    }
    out_counts[t] = (i32)c;
  }
}

// Sub-sub-mid 3-walk edge support (house/T3 decomposition, round 5).
// Rows must be sorted ascending with sub-core ids (< cs) as the prefix.
// For every DAG edge (u, v) with v > u (CSR entries where col > row),
// out[csr_pos] = #{(x, y): x in N(u), y in N(v), x ~ y, x < cs, y < cs}
// — the (sub, sub) middle-edge share of T3(u,v) = |edges between N(u)
// and N(v)| (ordered sides). The core-mid shares run on the device (matmul
// bilinear + WS-table dots, ops/house.py); this bounded part costs
// O(sum_{x sub} deg(x) * ssdeg(x)) build + O(sum_v deg(v) * ftw(v))
// L2-resident lookups. Entries at col <= row are left untouched.
void gm_t3ss(i64 V, const i64* rowptr, const i32* colidx, i64 cs,
             i32* out) {
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<i32> w2(V, 0);
    std::vector<i32> touched;
    touched.reserve(4096);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (i64 u = 0; u < V; ++u) {
      // w2[y] = # sub x in N(u) with y in N(x), y sub
      for (i64 p = rowptr[u]; p < rowptr[u + 1]; ++p) {
        const i32 x = colidx[p];
        if (x >= cs) break;  // sorted: sub prefix done
        for (i64 q = rowptr[x]; q < rowptr[x + 1]; ++q) {
          const i32 y = colidx[q];
          if (y >= cs) break;
          if (w2[y]++ == 0) touched.push_back(y);
        }
      }
      if (!touched.empty()) {
        for (i64 p = rowptr[u]; p < rowptr[u + 1]; ++p) {
          const i32 v = colidx[p];
          if (v <= u) continue;  // emit each undirected edge once (v > u)
          i64 s = 0;
          for (i64 q = rowptr[v]; q < rowptr[v + 1]; ++q) {
            const i32 y = colidx[q];
            if (y >= cs) break;
            s += w2[y];
          }
          out[p] = (i32)s;
        }
        for (const i32 y : touched) w2[y] = 0;
        touched.clear();
      } else {
        for (i64 p = rowptr[u]; p < rowptr[u + 1]; ++p)
          if (colidx[p] > u) out[p] = 0;
      }
    }
  }
}

// Max-anchored 4-cycle count (the Chiba–Nishizeki wedge pass; ids ARE the
// anchor order). total = Σ_v Σ_{w<v} C(cnt, 2) with cnt = #{u ∈ N(v) ∩
// N(w): u < v} — each 4-cycle counted once at the diagonal holding its
// max vertex (the same anchoring as ops/rectangle.py's matmul form). Used as
// the bounded-degree closer of the recursion: work = Σ wedges with both
// legs below the anchor ≈ wedges/2 — affordable exactly where the core
// split has peeled the hubs away. Rows must be sorted ascending.
i64 gm_c4(i64 V, const i64* rowptr, const i32* colidx) {
  i64 total = 0;
#ifdef _OPENMP
#pragma omp parallel reduction(+ : total)
#endif
  {
    std::vector<i32> cnt(V, 0);
    std::vector<i32> touched;
    touched.reserve(4096);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (i64 v = 0; v < V; ++v) {
      for (i64 p = rowptr[v]; p < rowptr[v + 1]; ++p) {
        const i32 u = colidx[p];
        if (u >= v) break;
        for (i64 q = rowptr[u]; q < rowptr[u + 1]; ++q) {
          const i32 w = colidx[q];
          if (w >= v) break;
          if (cnt[w]++ == 0) touched.push_back(w);
        }
      }
      for (const i32 w : touched) {
        const i64 c = cnt[w];
        total += c * (c - 1) / 2;
        cnt[w] = 0;
      }
      touched.clear();
    }
  }
  return total;
}

namespace {

// sorted-merge intersection of cand[0..n) with N+(u); writes to out
i64 isect_row(const i64* rowptr, const i32* colidx, const i32* cand, i64 n,
              i32 u, i32* out) {
  i64 a = 0, b = rowptr[u];
  const i64 bend = rowptr[u + 1];
  i64 m = 0;
  while (a < n && b < bend) {
    const i32 x = cand[a], y = colidx[b];
    if (x < y) ++a;
    else if (y < x) ++b;
    else { out[m++] = x; ++a; ++b; }
  }
  return m;
}

i64 dfs_kclique(const i64* rowptr, const i32* colidx, const i32* cand,
                i64 n, i64 depth, i64 k, i32* scratch, i64 maxd) {
  if (depth == k - 1) return n;
  i64 tot = 0;
  for (i64 i = 0; i < n; ++i) {
    const i64 m = isect_row(rowptr, colidx, cand, n, cand[i], scratch);
    if (m) tot += dfs_kclique(rowptr, colidx, scratch, m, depth + 1, k,
                              scratch + maxd, maxd);
  }
  return tot;
}

}  // namespace

// Reference-style DAG DFS k-clique counter (the automine_omp.h:159-183
// nested-loop semantics with sorted-merge intersections) — an INDEPENDENT
// conformance backend for the bitmap/bilinear engines: different
// algorithm family (per-vertex DFS + 2-pointer merges vs hi/lo matmul
// bilinears + popcount streams), shares no code with them. Input must be
// the oriented DAG with sorted rows.
i64 gm_kclique(i64 V, const i64* rowptr, const i32* colidx, i64 k) {
  i64 maxd = 0;
  for (i64 v = 0; v < V; ++v)
    maxd = std::max(maxd, rowptr[v + 1] - rowptr[v]);
  if (k < 2 || maxd == 0) return k == 1 ? V : 0;
  i64 total = 0;
#ifdef _OPENMP
#pragma omp parallel reduction(+ : total)
#endif
  {
    std::vector<i32> scratch((size_t)maxd * std::max<i64>(1, k - 2));
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (i64 v = 0; v < V; ++v) {
      const i64 n = rowptr[v + 1] - rowptr[v];
      if (n < k - 1) continue;
      total += dfs_kclique(rowptr, colidx, colidx + rowptr[v], n, 1, k,
                           scratch.data(), maxd);
    }
  }
  return total;
}

// Per-vertex degree histogram utility (scheduler work estimates).
void gm_degrees(i64 V, const i64* rowptr, i32* deg) {
#pragma omp parallel for schedule(static)
  for (i64 v = 0; v < V; ++v) deg[v] = (i32)(rowptr[v + 1] - rowptr[v]);
}

int gm_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
