// The narrow iteration of the sweeps loop: one pod evaluated, its chain
// committed. Device counterpart of karpenter_tpu_torch/ops/ffd_chain.py (the
// JAX package's ops/ffd_sweeps.py _make_stride narrow_iter :872, default
// switches: _STRIDE 64, _SPREAD_CHAIN and _TOPO_CHAIN on).
//
// The pod at the queue cursor heads a chain of ``kc`` chain-identical queue
// successors (pod_eqprev_chain), counted by the caller. step_eval judges the
// head; the chain then commits in one of four closed forms, each equal to
// stepping the members one at a time:
//   single  the head's bin takes the chain while the per-pod fit and, for a
//           claim, the fewest-pods rank hold (a FAIL or NO_SLOT verdict
//           covers the whole chain);
//   fill    the chain waterfills over every eligible claim (the run commit's
//           math: one warp's water level, then the members in pour order,
//           level by level and claims in slot order, in one pass) when no
//           record feeds back into its gates;
//   round   one closed-form round of a maxSkew-1 spread: m rounds of a
//           block atomicMin over the open lanes' winning claims;
//   spread  a mini-scan of the spread group's counters over the chain, a
//           claim per warp and the group's lanes across it, one member a
//           step, with its exactness guards and the fallback to single.
// The topology record weights one unit record per committed bin row by the
// members' select/owned rows. A chain of one (and a claim opening) commits
// through step_commit.
//
// On the cluster (step.cuh ClusterScope) every block runs the chain's
// analysis and its branch the same way on its own scratch rows (FfdArgs::
// chain_c and chain_v hold one set per block); only the wide parts meet:
// the spread's type rows and its insensitivity check over each block's
// slice of the types, the committed survivors rows over the slices, the
// leader block's state rows and the records on the cluster's warps.
#pragma once

#include "step.cuh"

namespace {

constexpr int STRIDE = 64;  // ffd_chain.STRIDE

// per-claim scratch rows of FfdArgs::chain_c, [cluster][NCS][C]: each
// block's own
constexpr int CS_CAP = 0;    // ChainEval::capc
constexpr int CS_PRE = 1;    // ChainEval::pre
constexpr int CS_TOPO = 2;   // ChainEval::topo
constexpr int CS_TAKE = 3;   // pods the commit gives the claim
constexpr int CS_LVL = 4;    // the claim's pods before the commit
constexpr int CS_LANE = 5;   // the claim's lowest lane on the spread key
constexpr int CS_NPODS = 6;  // the spread mini-scan's pods
constexpr int CS_SCAP = 7;   // the spread mini-scan's capacity
constexpr int CS_PIN = 8;    // the lane the mini-scan pinned, or -1
constexpr int CS_COK = 9;    // ChainEval::cok
constexpr int CS_LIST = 10;  // the claims that took pods, in slot order
constexpr int CS_USTART = 11;  // the fill: the ordinal of each listed claim's first unit
constexpr int NCS = 12;
// per-lane scratch rows of FfdArgs::chain_v, [cluster][NVS][V]
constexpr int VS_COUNTS = 0;  // the spread mini-scan's counts
constexpr int VS_BEST = 1;    // the lane's best claim priority (round)
constexpr int NVS = 2;

struct ChainShared {
  int kc, k;  // chain members; members committed
  int stack_safe, fill_safe, spread, g, kg, s_gi, skew, md, is_host;
  int gmin_zero, gmin, nsup, ok_struct, n_win, branch, m, best, cut, alive, insensitive;
  int ntk;         // claims in CS_LIST
  int of[STRIDE];  // each committed member's index (claim, node or -1)
};

// The chain at queue cursor i: consecutive rows from p, each
// chain-identical to its predecessor, at most STRIDE (one warp's ballots).
__device__ __forceinline__ int chain_run(const int* q, int i, int qlen, int p, const uint8_t* eqprev) {
  const int lane = threadIdx.x & 31;
  auto on = [&](int x) { return x < STRIDE && i + x < qlen && q[i + x] == p + x && eqprev[p + x]; };
  const unsigned w1 = __ballot_sync(FULL, on(lane + 1));
  if (~w1) return __ffs(~w1);
  const unsigned w2 = __ballot_sync(FULL, on(lane + 33));
  return 33 + __ffs(~w2) - 1;
}

// claim c's lane v on the spread key of the merged row (claim_merged)
template <class A>
__device__ __forceinline__ bool lane_cm(const A& a, int p, int c, int kg, int v) {
  return bit_of(a.claim_adm + ((long)c * a.K + kg) * a.W, v) && bit_of(a.pod_adm + ((long)p * a.K + kg) * a.W, v);
}

// One warp: the claims with a take, in slot order, into ``list`` (their
// count returned) and, with ``ustart``, each one's first unit: the units of
// the takes numbered in slot order.
__device__ int warp_take_list(const int* take, int C, int* list, int* ustart) {
  const int lane = threadIdx.x & 31;
  int n = 0, base = 0;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const int tk = c < C ? take[c] : 0;
    const unsigned word = __ballot_sync(FULL, tk > 0);
    int incl = tk;  // inclusive scan of the takes over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (tk > 0) {
      const int at = n + __popc(word & ((1u << lane) - 1u));
      list[at] = c;
      if (ustart) ustart[at] = base + incl - tk;
    }
    n += __popc(word);
    base += __shfl_sync(FULL, incl, 31);
  }
  return n;
}

// The fill's members in pour order (ffd_chain fill's claim_of): claim c's
// units sit at levels lvl[c] .. lvl[c] + take[c] - 1, and the units pour
// level by level, a level's claims in slot order; member s takes the s-th
// unit. Threads over the units: each counts the units that pour before its
// own (those at lower levels, and at its level of claims before its own) over
// the ``n`` listed claims, and writes its claim at that rank.
__device__ void fill_members(const int* lvl, const int* take, const int* list, const int* ustart, int n, int k,
                             int* of) {
  for (int u = threadIdx.x; u < k; u += THREADS) {
    int i = 0;
    while (i + 1 < n && ustart[i + 1] <= u) ++i;
    const int c = list[i], L = lvl[c] + u - ustart[i];
    int rank = 0;
    for (int x = 0; x < n; ++x) {
      const int c2 = list[x];
      rank += min(max(L - lvl[c2], 0), take[c2]) + (c2 < c && lvl[c2] <= L && L < lvl[c2] + take[c2]);
    }
    of[rank] = c;
  }
}

// whether instance type t admits and offers lane v of key kg alone (the
// JAX package's synthetic single-lane rows through the type gates)
template <class A>
__device__ bool lane_type_ok(const ITs& its, const A& a, int kg, int v, int t) {
  const long tk = (long)t * a.K + kg;
  if (its.def[tk] && !bit_of(its.adm + tk * a.W, v)) return false;
  const int O = a.O;
  for (int o = 0; o < O; ++o) {
    const long to = (long)t * O + o;
    if (!its.offer_ok[to]) continue;
    const int z = its.offer_zone[to], ct = its.offer_ct[to];
    const bool zok = kg == ZONE_KEY ? z == v : bit_of(a.lvw + ZONE_KEY * a.W, z);
    const bool cok = kg == CT_KEY ? ct == v : bit_of(a.lvw + CT_KEY * a.W, ct);
    if (zok && cok) return true;
  }
  return false;
}

// one warp copies scratch row ``b`` into entity row ``e``
template <class A>
__device__ void warp_row_copy(const A& a, int b, int* adm, uint8_t* comp, uint8_t* def, int* gt, int* lt, int e) {
  const int lane = threadIdx.x & 31, K = a.K, W = a.W;
  for (int i = lane; i < K * W; i += 32) adm[(long)e * K * W + i] = a.fin_adm[(long)b * K * W + i];
  for (int k = lane; k < K; k += 32) {
    comp[(long)e * K + k] = a.fin_comp[(long)b * K + k];
    def[(long)e * K + k] = a.fin_def[(long)b * K + k];
    gt[(long)e * K + k] = a.fin_gt[(long)b * K + k];
    lt[(long)e * K + k] = a.fin_lt[(long)b * K + k];
  }
}

// Topology.Record of the committed members: per group (a warp of the
// scope), one unit record per bin that took members, weighted by the
// members' own select (inverse groups: owned) rows. ``node`` >= 0: the k
// members went to that node; else the claims of ``list`` (n of them) took
// them, member s to claim cs.of[s].
template <class S, class A>
__device__ void chain_record(const S& sc, const A& a, int p, int node, const ChainShared& cs, const int* list,
                             int n) {
  const int lane = threadIdx.x & 31;
  const int K = a.K, W = a.W, N = a.N, G = a.G, k = cs.k;
  const TopoGroups tg = topo_of(a);
  for (int g = sc.gwarp(); g < G; g += sc.nwarps()) {
    const int kg = a.grp_key[g];
    const uint8_t* w_src = a.grp_inverse[g] ? a.pod_owned : a.pod_selects;
    const int nb = node >= 0 ? 1 : n;
    for (int i = 0; i < nb; ++i) {
      const int c = node >= 0 ? -1 : list[i];
      int w = 0;
      for (int s = lane; s < k; s += 32)
        if (node >= 0 || cs.of[s] == c) w += w_src[(long)(p + s) * G + g];
      w = warp_sum(w);
      if (w == 0) continue;
      const int b = node >= 0 ? node : N + c;
      const Row row = fin_row(a, b);
      if (!records_group(tg, g, row, a.fin_neg + (long)b * K, true, true, node >= 0 ? nullptr : a.wellknown, K, W))
        continue;
      if (lane == 0) count_work(WORK_TOPO_LANES, a.V);
      for (int v = lane; v < a.V; v += 32) {
        if (bit_of(row.adm + kg * W, v)) {
          a.grp_counts[(long)g * a.V + v] += w;
          a.grp_registered[(long)g * a.V + v] = 1;
        }
      }
    }
  }
}

// Pods like p that node n still takes: resources, volumes, ports (one
// thread).
template <class A>
__device__ int node_fit(const A& a, int p, int n) {
  const int R = a.R;
  int fit = capacity(a.node_avail + (long)n * R, a.node_requests + (long)n * R, a.pod_requests + (long)p * R, R);
  for (int d = 0; d < a.D; ++d) {
    const int pv = a.pod_vols[(long)p * a.D + d];
    if (pv <= 0) continue;
    // an over-limit attach count reads as 0 capacity, not negative
    const int room = a.node_vol_limits[(long)n * a.D + d] - a.node_vol_used[(long)n * a.D + d];
    fit = min(fit, room > 0 ? room / pv : 0);
  }
  for (int q = 0; q < a.PT; ++q)
    if (a.pod_ports[(long)p * a.PT + q]) fit = min(fit, 1);
  return fit;
}

// The block's chain scratch rows (chain_c, chain_v) and the evaluation's
// view of them.
struct ChainRows {
  int *capc, *pre, *topo, *take, *lvl, *clane, *snp, *scap, *pin, *cok, *list, *ustart;
  int *vcounts, *vbest;
  ChainEval ch;
};

template <class S, class A>
__device__ __forceinline__ ChainRows chain_rows_of(const S& sc, const A& a) {
  const long stride = (long)NCS * a.C;
  int* cc = a.chain_c + sc.rank * stride;
  int* cv = a.chain_v + (long)sc.rank * NVS * a.V;
  ChainRows r;
  r.capc = cc + CS_CAP * a.C;
  r.pre = cc + CS_PRE * a.C;
  r.topo = cc + CS_TOPO * a.C;
  r.take = cc + CS_TAKE * a.C;
  r.lvl = cc + CS_LVL * a.C;
  r.clane = cc + CS_LANE * a.C;
  r.snp = cc + CS_NPODS * a.C;
  r.scap = cc + CS_SCAP * a.C;
  r.pin = cc + CS_PIN * a.C;
  r.cok = cc + CS_COK * a.C;
  r.list = cc + CS_LIST * a.C;
  r.ustart = cc + CS_USTART * a.C;
  r.vcounts = cv + VS_COUNTS * a.V;
  r.vbest = cv + VS_BEST * a.V;
  r.ch = ChainEval{r.capc, r.pre, r.topo, r.cok, stride};
  return r;
}

// One narrow iteration for the pod p heading a chain of cs.kc members (set
// by the caller before a barrier). Leaves the verdict in s.kind, the members
// committed in cs.k and their indices in cs.of, in every block. The caller
// puts a cluster barrier after it before anything reads the state.
template <class S, class A>
__device__ void narrow_iter(const S& sc, const A& a, int p, Shared& s, ChainShared& cs, Red& red, const StepMem& m) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, W = a.W, N = a.N, C = a.C, T = a.T, V = a.V, G = a.G, R = a.R;
  const int kc = cs.kc;
  const TypeSlice& ts = sc.ts;
  const ChainRows cr = chain_rows_of(sc, a);
  int* capc = cr.capc;
  int* pre = cr.pre;
  int* topo = cr.topo;
  int* take = cr.take;
  int* lvl = cr.lvl;
  int* clane = cr.clane;
  int* snp = cr.snp;
  int* scap = cr.scap;
  int* pin = cr.pin;
  int* vcounts = cr.vcounts;
  int* vbest = cr.vbest;
  step_eval(sc, a, p, s, red, m, nullptr, kc > 1 ? &cr.ch : nullptr);
  const int kind = s.kind, idx = s.index;
  if (kc == 1 || kind == KIND_NEW_CLAIM) {
    step_commit(sc, a, p, s, m, nullptr, true);
    if (tid == 0) {
      cs.k = 1;
      cs.of[0] = idx;
    }
    return;
  }
  if (kind == KIND_FAIL || kind == KIND_NO_SLOT) {
    sc.mark(SEC_QUEUE);
    // the verdict replicates over the whole chain
    if (tid == 0) cs.k = kc;
    for (int x = tid; x < kc; x += THREADS) cs.of[x] = -1;
    return;
  }

  // -- record -> gate feedback: the chain may stack when no group both gates
  // the pod and receives its records, except regular affinity groups; it may
  // waterfill when each such group is already positive in the pod's domains
  const uint8_t* match = a.pod_match + (long)p * G;
  const uint8_t* sel = a.pod_selects + (long)p * G;
  const uint8_t* own = a.pod_owned + (long)p * G;
  sc.mark(SEC_CHAIN);
  if (tid == 0) {
    cs.stack_safe = 1;
    cs.fill_safe = 1;
  }
  block_sync();
  for (int g = warp; g < G; g += NWARPS) {
    const bool inv = a.grp_inverse[g];
    if (!(match[g] && ((sel[g] && !inv) || (own[g] && inv)))) continue;
    const int* pdw = a.pod_strict_adm + ((long)p * K + a.grp_key[g]) * W;
    bool pos = false;
    for (int v = lane; v < V; v += 32)
      pos |= a.grp_registered[(long)g * V + v] && a.grp_counts[(long)g * V + v] > 0 && bit_of(pdw, v);
    pos = __any_sync(FULL, pos);
    if (lane == 0) {
      if (!(a.grp_type[g] == 1 && !inv)) cs.stack_safe = 0;
      if (!pos) cs.fill_safe = 0;
    }
  }
  block_sync();

  if (kind == KIND_NODE) {
    if (tid == 0) cs.k = max(min(kc, cs.stack_safe ? node_fit(a, p, idx) : 1), 1);
    block_sync();
    sc.mark(SEC_COMMIT);
    const int k = cs.k;
    for (int x = tid; x < k; x += THREADS) cs.of[x] = idx;
    if (k == 1) {
      step_commit(sc, a, p, s, m, nullptr, true);
      return;
    }
    if (sc.leader()) {
      const float* preq = a.pod_requests + (long)p * R;
      copy_row(a, idx, a.node_adm, a.node_comp, a.node_def, a.node_gt, a.node_lt, idx);
      for (int r = tid; r < R; r += THREADS)
        a.node_requests[(long)idx * R + r] = add_times(a.node_requests[(long)idx * R + r], k, preq[r]);
      for (int q = tid; q < a.PT; q += THREADS) a.node_ports[(long)idx * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
      for (int d = tid; d < a.D; d += THREADS) a.node_vol_used[(long)idx * a.D + d] += k * a.pod_vols[(long)p * a.D + d];
      if (tid == 0) a.node_npods[idx] += k;
    }
    sc.mark(SEC_RECORD);
    if (G > 0) chain_record(sc, a, p, idx, cs, nullptr, 0);
    return;
  }

  // -- a claim: the spread shape (exactly one matched group, a regular
  // spread with no node filter, nothing else owned), one warp over the groups
  for (int c = tid; c < C; c += THREADS) {
    take[c] = 0;
    pin[c] = -1;
  }
  if (warp == 0) {
    int nm = 0, gm = -1;
    bool bad = false;
    for (int g = lane; g < G; g += 32) {
      if (match[g]) {
        ++nm;
        gm = g;
      }
      if (own[g] && (!match[g] || a.grp_inverse[g])) bad = true;
    }
    nm = warp_sum(nm);
    gm = max(warp_max(gm), 0);  // the last matched group, as a scan in order keeps
    bad = __any_sync(FULL, bad);
    if (lane == 0) {
      cs.spread = nm == 1 && a.grp_type[gm] == 0 && !a.grp_has_filter[gm] && !a.grp_inverse[gm] && !bad;
      cs.g = gm;
      cs.kg = G > 0 ? a.grp_key[gm] : 0;
      cs.s_gi = G > 0 ? (match[gm] && sel[gm]) : 0;
      cs.skew = G > 0 ? a.grp_max_skew[gm] : 0;
      cs.md = G > 0 ? a.grp_min_domains[gm] : -1;
      cs.is_host = G > 0 && cs.kg == HOSTNAME_KEY;
      cs.gmin = MAXI;
      cs.nsup = 0;
      cs.ok_struct = 1;
      cs.n_win = 0;
    }
  }
  block_sync();
  const bool spread = cs.spread;
  const int g = cs.g, kg = cs.kg, s_gi = cs.s_gi;
  const int* pdom = a.pod_strict_adm + ((long)p * K + kg) * W;
  auto sup = [&](int v) { return a.grp_registered[(long)g * V + v] && bit_of(pdom, v); };
  if (spread) {
    for (int v = tid; v < V; v += THREADS)
      if (sup(v)) {
        atomicMin(&cs.gmin, a.grp_counts[(long)g * V + v]);
        atomicAdd(&cs.nsup, 1);
      }
    block_sync();
    if (tid == 0) {
      cs.gmin_zero = cs.is_host || (cs.md >= 0 && cs.nsup < cs.md);
      if (cs.gmin_zero) cs.gmin = 0;
    }
    block_sync();
    if (s_gi == 1 && cs.skew == 1) {
      // the round's structure: every fillable claim sits on one supported
      // lane; the open lanes' winning claims
      const int gmin0 = cs.gmin;
      for (int c = warp; c < C; c += NWARPS) {
        if (capc[c] <= 0) continue;
        int pop = 0, first = MAXI;
        for (int j = 0; j < W; ++j) {
          const bool on = lane_cm(a, p, c, kg, 32 * j + lane);
          const unsigned word = __ballot_sync(FULL, on);
          pop += __popc(word);
          if (word && first == MAXI) first = 32 * j + __ffs(word) - 1;
        }
        if (lane == 0) {
          clane[c] = first == MAXI ? 0 : first;
          if (pop != 1 || !sup(clane[c])) cs.ok_struct = 0;
        }
      }
      for (int v = tid; v < V; v += THREADS) vbest[v] = MAXI;
      block_sync();
      if (cs.ok_struct) {
        for (int c = tid; c < C; c += THREADS) {
          if (capc[c] <= 0) continue;
          const int v = clane[c];
          if (sup(v) && a.grp_counts[(long)g * V + v] == gmin0) atomicMin(&vbest[v], a.claim_npods[c] * C + c);
        }
        block_sync();
        for (int v = tid; v < V; v += THREADS)
          if (vbest[v] < MAXI) atomicAdd(&cs.n_win, 1);
      }
      block_sync();
    }
  }
  if (tid == 0) {
    const bool use_fill = cs.fill_safe && cs.stack_safe;
    const bool use_round = !use_fill && spread && s_gi == 1 && cs.skew == 1 && cs.ok_struct && cs.n_win >= kc;
    const bool use_spread = !use_fill && !use_round && spread && !s.node_static;
    cs.branch = use_fill ? 1 : use_round ? 2 : use_spread ? 3 : 0;
    cs.k = 0;
  }
  block_sync();
  const int branch = cs.branch;
  sc.mark(branch == 1 ? SEC_FILL : branch == 2 ? SEC_ROUND : branch == 3 ? SEC_SPREAD : SEC_SINGLE);

  if (branch == 1) {
    // fill: pour the chain into the lowest claims, bounded by capacity (one
    // warp: the water level, the leftover units to the claims at the level
    // with room in slot order, the claims with a take; then the members in
    // pour order, threads over the units)
    if (warp == 0) {
      int sum = 0;
      for (int c = lane; c < C; c += 32) {
        sum += capc[c];
        lvl[c] = a.claim_npods[c];
      }
      sum = warp_sum(sum);
      __syncwarp();
      const int m_units = min(kc, sum);
      const int L = warp_water_level(lvl, capc, C, m_units);
      int taken = 0;
      for (int c = lane; c < C; c += 32) {
        take[c] = min(max(L - lvl[c], 0), capc[c]);
        taken += take[c];
      }
      const int leftover = m_units - warp_sum(taken);
      int at_count = 0;
      for (int c0 = 0; c0 < C; c0 += 32) {
        const int c = c0 + lane;
        const bool at = c < C && lvl[c] + take[c] == L && take[c] < capc[c];
        const unsigned word = __ballot_sync(FULL, at);
        if (at && at_count + __popc(word & ((1u << lane) - 1u)) + 1 <= leftover) take[c] += 1;
        at_count += __popc(word);
      }
      __syncwarp();
      const int n = warp_take_list(take, C, cr.list, cr.ustart);
      if (lane == 0) {
        cs.k = m_units;
        cs.ntk = n;
      }
    }
    block_sync();
    fill_members(lvl, take, cr.list, cr.ustart, cs.ntk, cs.k, cs.of);
  } else if (branch == 2) {
    // round: the open lanes' winning claims in fewest-pods order
    const int m_round = min(kc, cs.n_win), gmin0 = cs.gmin;
    for (int r = 0; r < m_round; ++r) {
      if (tid == 0) cs.best = BIG;
      block_sync();
      for (int c = tid; c < C; c += THREADS) {
        if (capc[c] <= 0 || take[c] > 0) continue;
        const int v = clane[c], prio = a.claim_npods[c] * C + c;
        if (sup(v) && a.grp_counts[(long)g * V + v] == gmin0 && vbest[v] == prio) atomicMin(&cs.best, prio);
      }
      block_sync();
      if (tid == 0) {
        const int c = cs.best % C;
        cs.of[r] = c;
        take[c] = 1;
      }
      block_sync();
    }
    if (tid == 0) cs.k = (m_round == 0 || cs.of[0] != idx) ? 0 : m_round;
  } else if (branch == 3) {
    // spread: the mini-scan, if type survival and capacity ignore the lane
    // on every type some open claim keeps (claim_it_ok2 of all of them: the
    // rows step_eval left out, of claims that fail their gates, first), each
    // block over its slice of the types, the verdict in the leader
    for (int c = warp; c < C; c += NWARPS) {
      if (!a.claim_open[c] || (pre[c] && topo[c])) continue;
      for (int t = ts.t0 + lane; t < ts.t1; t += 32) ts.ok_t[(long)c * ts.tstride + t] = claim_type_ok(ts, a, p, c, t);
      if (sc.leader() && lane == 0) count_work(WORK_TYPE_TESTS, T);
    }
    block_sync();
    Red* red0 = sc.lead(&red);
    for (int t = ts.t0 + tid; t < ts.t1; t += THREADS) {
      bool relevant = false;
      for (int c = 0; c < C && !relevant; ++c) relevant = a.claim_open[c] && ts.ok_t[(long)c * ts.tstride + t];
      if (!relevant) continue;
      for (int v = 0; v < V; ++v)
        if (sup(v) && !lane_type_ok(ts.its, a, kg, v, t)) {
          atomicAnd(&red0->insensitive, 0);
          break;
        }
    }
    for (int c = tid; c < C; c += THREADS) {
      snp[c] = a.claim_npods[c];
      scap[c] = capc[c];
    }
    for (int v = tid; v < V; v += THREADS) vcounts[v] = a.grp_counts[(long)g * V + v];
    sc.sync();
    if (tid == 0) cs.insensitive = red0->insensitive;
    block_sync();
    const bool gmin_zero = cs.gmin_zero;
    for (int st = 0; st < kc; ++st) {
      if (tid == 0) {
        cs.best = BIG;
        cs.cut = BIG;
        cs.gmin = gmin_zero ? 0 : MAXI;
      }
      block_sync();
      if (!gmin_zero)
        for (int v = tid; v < V; v += THREADS)
          if (sup(v)) atomicMin(&cs.gmin, vcounts[v]);
      block_sync();
      const int gm = cs.gmin;
      for (int c = warp; c < C; c += NWARPS) {
        if (!a.claim_open[c]) continue;
        bool any = false;
        for (int v = lane; v < V; v += 32) {
          const bool on = pin[c] >= 0 ? v == pin[c] : lane_cm(a, p, c, kg, v);
          any |= on && a.grp_registered[(long)g * V + v] && vcounts[v] + s_gi - gm <= cs.skew;
        }
        any = __any_sync(FULL, any);
        if (lane == 0 && any) {
          if (scap[c] > 0) atomicMin(&cs.best, snp[c] * C + c);
          if (pre[c] && !topo[c]) atomicMin(&cs.cut, snp[c] * C + c);
        }
      }
      block_sync();
      if (tid == 0) cs.alive = cs.best < BIG && !(cs.cut < cs.best);
      block_sync();
      if (!cs.alive) break;
      if (warp == 0) {
        // the picked claim's best lane: lowest count, lexicographic ties
        const int c = cs.best % C;
        int best = MAXI;
        for (int v = lane; v < V; v += 32) {
          const bool on = pin[c] >= 0 ? v == pin[c] : lane_cm(a, p, c, kg, v);
          const int self = vcounts[v] + s_gi;
          if (on && a.grp_registered[(long)g * V + v] && self - gm <= cs.skew)
            best = min(best, self * V + min(a.lex[(long)kg * V + v], V - 1));
        }
        best = warp_min(best);
        int lane_v = MAXI;
        for (int v = lane; v < V; v += 32) {
          const bool on = pin[c] >= 0 ? v == pin[c] : lane_cm(a, p, c, kg, v);
          const int self = vcounts[v] + s_gi;
          if (on && a.grp_registered[(long)g * V + v] && self - gm <= cs.skew &&
              self * V + min(a.lex[(long)kg * V + v], V - 1) == best)
            lane_v = min(lane_v, v);
        }
        lane_v = warp_min(lane_v);
        if (lane == 0) {
          vcounts[lane_v] += s_gi;
          snp[c] += 1;
          scap[c] -= 1;
          pin[c] = lane_v;
          take[c] += 1;
          cs.of[st] = c;
          cs.k = st + 1;
        }
      }
      block_sync();
    }
    if (tid == 0 && (!cs.insensitive || cs.k == 0 || cs.of[0] != idx)) cs.k = 0;
  }
  block_sync();
  if (cs.k == 0) {
    sc.mark(SEC_SINGLE);
    // single: the pick takes the chain while it fits and stays the
    // fewest-pods claim with its stack-mates aboard
    for (int c = tid; c < C; c += THREADS) {
      take[c] = 0;
      pin[c] = -1;
    }
    block_sync();
    if (tid == 0) {
      const int j_rank = (s.rank2 - 1 - idx) / C - a.claim_npods[idx] + 1;
      const int k1 = max(min(kc, cs.stack_safe ? min(capc[idx], j_rank) : 1), 1);
      take[idx] = k1;
      cs.k = k1;
    }
    block_sync();
    for (int x = tid; x < cs.k; x += THREADS) cs.of[x] = idx;
    if (cs.k == 1) {
      step_commit(sc, a, p, s, m, nullptr, true);
      return;
    }
  }
  sc.mark(SEC_COMMIT);

  // -- commit each claim's take: the claims that took pods, listed in slot
  // order; first every block's slice of their survivors rows (the type keeps
  // the claim while cap_t >= take: cap_t saturates at 255 and take <= kc <=
  // STRIDE, so the saturated compare equals the exact one) and the leader's
  // pins (a spread pin replaces the committed row's lanes on the group key by
  // the pinned lane); then the leader's state rows and the records
  if (warp == 0) {
    const int n = warp_take_list(take, C, cr.list, nullptr);
    if (lane == 0) cs.ntk = n;
  }
  block_sync();
  const int ntk = cs.ntk;
  for (int i = warp; i < ntk; i += NWARPS) {
    const int c = cr.list[i], tk = take[c];
    for (int t = ts.t0 + lane; t < ts.t1; t += 32)
      ts.cio[(long)c * ts.tstride + t] = ts.ok_t[(long)c * ts.tstride + t] && ts.cap_t[(long)c * ts.tstride + t] >= tk;
    if (sc.leader() && lane == 0) count_work(WORK_TYPE_TESTS, T);
    if (sc.leader() && pin[c] >= 0) {
      const int b = N + c;
      int* fw = a.fin_adm + ((long)b * K + kg) * W;
      for (int w = lane; w < W; w += 32) fw[w] = (w == (pin[c] >> 5)) ? (int)(1u << (pin[c] & 31)) : 0;
      __syncwarp();
      if (lane == 0)
        a.fin_neg[(long)b * K + kg] = negative_polarity_key(fw, a.fin_comp[(long)b * K + kg], a.fin_gt[(long)b * K + kg],
                                                           a.fin_lt[(long)b * K + kg], a.lvw + kg * W,
                                                           a.ln + (long)kg * V, W);
      __syncwarp();
    }
  }
  sc.sync();
  if (sc.leader()) {
    const float* preq = a.pod_requests + (long)p * R;
    for (int i = warp; i < ntk; i += NWARPS) {
      const int c = cr.list[i], tk = take[c];
      warp_row_copy(a, N + c, a.claim_adm, a.claim_comp, a.claim_def, a.claim_gt, a.claim_lt, c);
      for (int r = lane; r < R; r += 32)
        a.claim_requests[(long)c * R + r] = add_times(a.claim_requests[(long)c * R + r], tk, preq[r]);
      for (int q = lane; q < a.PT; q += 32) a.claim_ports[(long)c * a.PT + q] |= a.pod_ports[(long)p * a.PT + q];
      if (lane == 0) a.claim_npods[c] += tk;
    }
  }
  sc.mark(SEC_RECORD);
  if (G > 0) chain_record(sc, a, p, -1, cs, cr.list, ntk);
}

}  // namespace
