// The wavefront of the sweeps loop (KARPENTER_TPU_WAVEFRONT): after a narrow
// iteration, up to ``wavefront`` further chain heads act in the same
// iteration. Device counterpart of karpenter_tpu_torch/ops/ffd_chain.py
// ``wave`` (the JAX package's ops/ffd_sweeps.py:473 _wave_extend).
//
// Every lane is judged against the state the first lane (narrow_iter) left:
// the cluster evaluates the lanes one after another with step_eval and
// commits none of them until the last has been judged, so each evaluation
// reads the same state. A lane acts only when its verdict provably equals the
// sequential one (its matched groups are disjoint from those earlier lanes
// record into; its node is untouched, or every claim an earlier lane touched
// is ineligible to it): a placement stacks its chain into its one bin up to
// the per-pod fit and, for a claim, the fewest-pods rank; a failure (no node,
// no claim, no template) sends the whole chain to the next sweep's queue. A
// lane that places less than its whole chain, or does not act, ends the
// wavefront.
//
// step_eval leaves its verdict in Shared, its rows in the fin_* scratch and
// the claims' type tables in ok_t / cap_t, all of which the next lane's
// evaluation overwrites: so each placing lane copies what its commit reads
// (the bin's narrowed row and polarity, by the leader block, and for a claim
// its survivors and capacities, each block its slice of the types) into a
// slab of its own in FfdArgs::wave. The commits and their topology records
// then run from the slabs, lane by lane. The records add up the same in any
// order, and the bins are distinct, so this equals the JAX package's summed
// record at the end. Every block keeps its own copy of the lanes' decisions
// (WaveShared, and the groups, claims and nodes earlier lanes touched).
//
// The slabs are sized from the shape (no K, V or T limit).
#pragma once

#include "chain.cuh"

namespace {

// a slab's scalars, then the row (K x W lane words; comp, def, gt, lt and
// polarity, one int each per key, the flags stored as bytes), then the
// claim's survivors (bytes in T ints) and per-type capacities (saturated at
// 255, as cap_t)
constexpr int WV_NODE = 0;  // 1: the lane placed on a node, 0: on a claim
constexpr int WV_IDX = 1;   // the node or claim
constexpr int WV_P = 2;     // the chain head's row
constexpr int WV_K = 3;     // members placed
constexpr int WV_SCALARS = 4;

struct WaveShared {
  int h, p, kch, cont, k, act, placed, n_lanes, n_place, consumed;
  int topo_indep, claim_indep, stack_safe;
  int commits, pods, retries;  // the loop's totals
};

struct Slab {
  int* sc;
  int* adm;
  uint8_t* comp;
  uint8_t* def;
  int* gt;
  int* lt;
  uint8_t* neg;
  uint8_t* ok_t;
  int* cap_t;
};

// the groups, claims and nodes earlier lanes touched: each block's own
template <class A>
__device__ __forceinline__ int* wave_marks(const A& a, int rank) {
  return a.wave + (long)rank * (a.G + a.C + max(a.N, 1));
}

template <class A>
__device__ __forceinline__ Slab slab_of(const A& a, int blocks, int j) {
  const int K = a.K, W = a.W, T = a.T;
  int* base = wave_marks(a, blocks) + (long)j * (WV_SCALARS + K * W + 5 * K + 2 * T);
  Slab sl;
  sl.sc = base;
  sl.adm = base + WV_SCALARS;
  int* rest = sl.adm + K * W;
  sl.comp = reinterpret_cast<uint8_t*>(rest);
  sl.def = reinterpret_cast<uint8_t*>(rest + K);
  sl.gt = rest + 2 * K;
  sl.lt = rest + 3 * K;
  sl.neg = reinterpret_cast<uint8_t*>(rest + 4 * K);
  sl.ok_t = reinterpret_cast<uint8_t*>(rest + 5 * K);
  sl.cap_t = rest + 5 * K + T;
  return sl;
}

// The wavefront from queue cursor h0 (the first lane's chain consumed, and
// ``cont`` whether further lanes may act). Writes the lanes' verdict rows and
// requeued rows (nq, s.nqlen), commits their placements and records, and
// leaves in ws the pods consumed and the lanes that acted.
template <class S, class A>
__device__ void wave_step(const S& sc, const A& a, const int* q, int h0, int qlen, bool cont, int* nq, Shared& s,
                          WaveShared& ws, Red& red, const StepMem& m) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, W = a.W, N = a.N, C = a.C, G = a.G, R = a.R;
  const TypeSlice& ts = sc.ts;
  int* eff = wave_marks(a, sc.rank);  // [G] groups earlier lanes record into
  int* tc = eff + G;                  // [C] claims earlier lanes placed on
  int* tn = tc + C;                   // [max(N, 1)] nodes earlier lanes placed on
  const ChainRows cr = chain_rows_of(sc, a);
  const ChainEval& ch = cr.ch;
  sc.mark(SEC_WAVE);
  for (int g = tid; g < G; g += THREADS) eff[g] = 0;
  for (int c = tid; c < C; c += THREADS) tc[c] = 0;
  for (int n = tid; n < max(N, 1); n += THREADS) tn[n] = 0;
  if (tid == 0) {
    ws.h = h0;
    ws.cont = cont;
    ws.n_lanes = 0;
    ws.n_place = 0;
    ws.consumed = 0;
  }
  block_sync();

  // -- judge the lanes in order against the unchanged state
  for (int j = 0; j < a.wavefront; ++j) {
    if (warp == 0) {
      int p = -1, kc = 0;
      if (ws.cont && ws.h < qlen) {
        p = q[ws.h];
        kc = chain_run(q, ws.h, qlen, p, a.pod_eqprev_chain);
      }
      if (lane == 0) {
        ws.p = p;
        ws.kch = kc;
      }
    }
    block_sync();
    const int p = ws.p;
    if (p < 0) break;
    const int kch = ws.kch;
    step_eval(sc, a, p, s, red, m, nullptr, &ch);
    sc.mark(SEC_WAVE);
    const int kind = s.kind, idx = s.index;
    if (tid == 0) {
      ws.topo_indep = 1;
      ws.claim_indep = 1;
      ws.stack_safe = 1;
    }
    block_sync();
    const uint8_t* match = a.pod_match + (long)p * G;
    for (int g = tid; g < G; g += THREADS) {
      const bool inv = a.grp_inverse[g];
      if (match[g] && eff[g]) ws.topo_indep = 0;
      const bool feedback = match[g] && ((a.pod_selects[(long)p * G + g] && !inv) || (a.pod_owned[(long)p * G + g] && inv));
      if (feedback && !(a.grp_type[g] == 1 && !inv)) ws.stack_safe = 0;
    }
    if (kind == KIND_CLAIM)
      for (int c = tid; c < C; c += THREADS)
        if (tc[c] && ch.capc[c] > 0) ws.claim_indep = 0;
    block_sync();
    if (tid == 0) {
      const bool is_node = kind == KIND_NODE, is_claim = kind == KIND_CLAIM;
      const bool placed = ws.topo_indep && ((is_node && !tn[idx]) || (is_claim && ws.claim_indep));
      const bool failed = ws.topo_indep && kind == KIND_FAIL;
      int k = 0;
      if (placed) {
        int fit, j_rank = BIG_CAP;
        if (is_node) {
          fit = node_fit(a, p, idx);
        } else {
          fit = ch.capc[idx];
          j_rank = (s.rank2 - 1 - idx) / C - a.claim_npods[idx] + 1;
        }
        k = max(min(ws.stack_safe ? min(fit, j_rank) : 1, kch), 1);
        if (sc.leader()) {
          int* sl = slab_of(a, sc.size, ws.n_place).sc;
          sl[WV_NODE] = is_node;
          sl[WV_IDX] = idx;
          sl[WV_P] = p;
          sl[WV_K] = k;
        }
        ws.n_place += 1;
        if (is_node)
          tn[idx] = 1;
        else
          tc[idx] = 1;
        ws.commits += 1;
        ws.pods += k;
      } else if (failed) {
        k = kch;
        for (int x = 0; x < kch; ++x) nq[s.nqlen++] = p + x;
        ws.retries += 1;
      }
      ws.k = k;
      ws.placed = placed;
      ws.act = placed || failed;
      if (ws.act) {
        ws.n_lanes += 1;
        ws.consumed += k;
        ws.h += k;
      }
      ws.cont = ws.act && k == kch;
    }
    block_sync();
    if (!ws.act) break;
    const int k = ws.k;
    const bool placed = ws.placed;
    if (sc.leader())
      for (int x = tid; x < k; x += THREADS) {
        a.kind[p + x] = placed ? kind : KIND_FAIL;
        a.index[p + x] = placed ? idx : -1;
      }
    if (placed) {
      // what the commit reads, before the next lane's evaluation overwrites it
      for (int g = tid; g < G; g += THREADS) {
        bool rec = false;
        for (int x = 0; x < kch && !rec; ++x)
          rec = a.pod_selects[(long)(p + x) * G + g] || a.pod_owned[(long)(p + x) * G + g];
        if (rec) eff[g] = 1;
      }
      const Slab sl = slab_of(a, sc.size, ws.n_place - 1);
      if (sc.leader()) {
        const int b = kind == KIND_NODE ? idx : N + idx;
        for (int x = tid; x < K * W; x += THREADS) sl.adm[x] = a.fin_adm[(long)b * K * W + x];
        for (int kk = tid; kk < K; kk += THREADS) {
          sl.comp[kk] = a.fin_comp[(long)b * K + kk];
          sl.def[kk] = a.fin_def[(long)b * K + kk];
          sl.gt[kk] = a.fin_gt[(long)b * K + kk];
          sl.lt[kk] = a.fin_lt[(long)b * K + kk];
          sl.neg[kk] = a.fin_neg[(long)b * K + kk];
        }
      }
      if (kind == KIND_CLAIM)
        for (int t = ts.t0 + tid; t < ts.t1; t += THREADS) {
          sl.ok_t[t] = ts.ok_t[(long)idx * ts.tstride + t];
          sl.cap_t[t] = ts.cap_t[(long)idx * ts.tstride + t];
        }
    }
    // the slabs and the leader's reduction targets read before the next
    // lane's evaluation overwrites the scratch and resets the targets
    sc.sync();
    if (!ws.cont) break;
  }
  sc.sync();

  // -- the placements, each into its own bin (the leader block's rows, every
  // block's slice of the survivors), then its record on the cluster's warps;
  // a barrier between two lanes, whose records may share a group
  sc.mark(SEC_COMMIT);
  const TopoGroups tg = topo_of(a);
  const int n_place = ws.n_place;
  for (int j = 0; j < n_place; ++j) {
    const Slab sl = slab_of(a, sc.size, j);
    const bool node = sl.sc[WV_NODE];
    const int idx = sl.sc[WV_IDX], p = sl.sc[WV_P], k = sl.sc[WV_K];
    const float* preq = a.pod_requests + (long)p * R;
    if (sc.leader()) {
      int* adm = node ? a.node_adm : a.claim_adm;
      uint8_t* comp = node ? a.node_comp : a.claim_comp;
      uint8_t* def = node ? a.node_def : a.claim_def;
      int* gt = node ? a.node_gt : a.claim_gt;
      int* lt = node ? a.node_lt : a.claim_lt;
      for (int x = tid; x < K * W; x += THREADS) adm[(long)idx * K * W + x] = sl.adm[x];
      for (int kk = tid; kk < K; kk += THREADS) {
        comp[(long)idx * K + kk] = sl.comp[kk];
        def[(long)idx * K + kk] = sl.def[kk];
        gt[(long)idx * K + kk] = sl.gt[kk];
        lt[(long)idx * K + kk] = sl.lt[kk];
      }
      if (node) {
        for (int r = tid; r < R; r += THREADS)
          a.node_requests[(long)idx * R + r] = add_times(a.node_requests[(long)idx * R + r], k, preq[r]);
        for (int x = tid; x < a.PT; x += THREADS) a.node_ports[(long)idx * a.PT + x] |= a.pod_ports[(long)p * a.PT + x];
        for (int d = tid; d < a.D; d += THREADS) a.node_vol_used[(long)idx * a.D + d] += k * a.pod_vols[(long)p * a.D + d];
        if (tid == 0) a.node_npods[idx] += k;
      } else {
        for (int r = tid; r < R; r += THREADS)
          a.claim_requests[(long)idx * R + r] = add_times(a.claim_requests[(long)idx * R + r], k, preq[r]);
        for (int x = tid; x < a.PT; x += THREADS) a.claim_ports[(long)idx * a.PT + x] |= a.pod_ports[(long)p * a.PT + x];
        if (tid == 0) {
          a.claim_npods[idx] += k;
          count_work(WORK_TYPE_TESTS, a.T);
        }
      }
    }
    // the survivors keep a type while its capacity covers the k members
    // (k <= the chain's STRIDE < 255, so the saturated capacity compares as
    // the exact one)
    if (!node)
      for (int t = ts.t0 + tid; t < ts.t1; t += THREADS)
        ts.cio[(long)idx * ts.tstride + t] = sl.ok_t[t] && sl.cap_t[t] >= k;
    // Topology.Record of the k members: a unit record of the bin's row per
    // group (a warp), weighted by the members' own select (inverse groups:
    // owned) rows
    Row row;
    row.adm = sl.adm;
    row.comp = sl.comp;
    row.def = sl.def;
    row.gt = sl.gt;
    row.lt = sl.lt;
    for (int g = sc.gwarp(); g < G; g += sc.nwarps()) {
      const uint8_t* w_src = a.grp_inverse[g] ? a.pod_owned : a.pod_selects;
      int w = 0;
      for (int x = lane; x < k; x += 32) w += w_src[(long)(p + x) * G + g];
      w = warp_sum(w);
      if (w == 0) continue;
      if (!records_group(tg, g, row, sl.neg, true, true, node ? nullptr : a.wellknown, K, W)) continue;
      const int kg = a.grp_key[g];
      if (lane == 0) count_work(WORK_TOPO_LANES, a.V);
      for (int v = lane; v < a.V; v += 32) {
        if (bit_of(row.adm + kg * W, v)) {
          a.grp_counts[(long)g * a.V + v] += w;
          a.grp_registered[(long)g * a.V + v] = 1;
        }
      }
    }
    sc.sync();
  }
}

}  // namespace
