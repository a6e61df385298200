// Native event-driven strategy simulator of flexflow_tpu_torch — the
// search's hot loop, a copy of the JAX package's engine so both packages
// simulate a strategy alike.
//
// The reference's simulator is native C++ (src/runtime/simulator.cc:275-448:
// build FORWARD/BACKWARD/COMM/UPDATE SimTasks, add dependency edges where
// producer/consumer partition rects intersect, run a priority-queue event
// simulation).  It is exposed through a C ABI consumed via ctypes
// (flexflow_tpu_torch/native/__init__.py); the Python Simulator
// (search/simulator.py) remains the reference implementation and the
// fallback, and the tests hold the two together.
//
// The engine is STATEFUL — the paper's delta-simulation technique
// (FlexFlow §5: re-simulate only the subgraph a proposal touches).
// ffsim_create marshals the static topology once per (mesh, model);
// ffsim_update_op replaces one op's row (times, partition degrees, device
// ids); ffsim_state_simulate re-simulates from cached state.  Three cost
// tiers, cheapest applicable wins:
//
//   * nothing changed             -> cached makespan (+ re-summed sync);
//   * only task TIMES changed     -> downstream-only delta repair: walk the
//     cached pop order, re-enqueue just the dirty frontier, stop where end
//     times stop changing.  Exactness is guarded: if a repaired task's
//     ready time ties or inverts against a device-queue neighbour (the
//     event loop's pop order could differ), or the frontier exceeds
//     `threshold` x tasks, fall back to a full in-engine replay;
//   * partition structure changed -> per-edge link specs (the O(parts^2)
//     rect intersections) are recomputed ONLY for edges incident to the
//     changed ops, then tasks are re-assembled linearly and replayed.
//
// Per-op fwd/bwd times arrive precomputed from Python (the analytic
// roofline or measure mode's CUDA-event timings).  The one-shot
// ffsim_simulate ABI is a thin create/update/simulate/destroy wrapper,
// bit-identical to the stateful path (same assembly order, same event
// loop, same tie-breaks).  The link arguments keep the JAX package's
// names: ici_bw is the link inside a host, dcn_bw the link between
// hosts.
//
// Built with g++ -O2 -shared -fPIC -std=c++17 at first use (no other
// dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr int MAXD = 4;

// [lo, hi) box of one partition (simulator.py::_part_rect)
struct Rect {
  int64_t lo[MAXD];
  int64_t hi[MAXD];
};

void part_rect(const int64_t* shape, const int64_t* dims, const int64_t* coord,
               int rank, Rect* out) {
  for (int i = 0; i < rank; i++) {
    int64_t step = shape[i] / dims[i];
    out->lo[i] = coord[i] * step;
    out->hi[i] = (coord[i] < dims[i] - 1) ? (coord[i] + 1) * step : shape[i];
  }
}

int64_t overlap_volume(const Rect& a, const Rect& b, int rank) {
  int64_t v = 1;
  for (int i = 0; i < rank; i++) {
    int64_t o = std::min(a.hi[i], b.hi[i]) - std::max(a.lo[i], b.lo[i]);
    if (o <= 0) return 0;
    v *= o;
  }
  return v;
}

// row-major enumeration of partition coordinates
void next_coord(int64_t* coord, const int64_t* dims, int rank) {
  for (int i = rank - 1; i >= 0; i--) {
    if (++coord[i] < dims[i]) return;
    coord[i] = 0;
  }
}

double transfer_time(double nbytes, bool intra, double ici_bw, double dcn_bw,
                     double latency) {
  if (nbytes <= 0) return 0.0;
  return latency + nbytes / (intra ? ici_bw : dcn_bw);
}

// One producer-part/consumer-part intersection of an input edge — the
// cached unit of delta simulation.  Rebuilding these (the O(parts^2)
// rect sweep) is the expensive half of a simulation; a single-op
// proposal invalidates only the links of edges touching that op.
struct Link {
  int32_t p;    // consumer part index
  int32_t q;    // producer part index
  double vol;   // overlap volume (elements)
};

struct OpRow {
  double fwd = 0.0, bwd = 0.0, sync = 0.0;
  int64_t dims[MAXD] = {1, 1, 1, 1};
  std::vector<int32_t> devs;
  bool init = false;
};

struct SimState {
  // ---- static topology (ffsim_create) ----
  int32_t n_ops = 0, num_devices = 1, dps = 1;
  double ici_bw = 1, dcn_bw = 1, latency = 0, dtype_bytes = 2;
  double threshold = 0.25;  // delta-repair frontier cap (fraction of tasks)
  std::vector<int32_t> rank;         // n_ops
  std::vector<int64_t> out_shape;    // n_ops * MAXD
  std::vector<int32_t> in_off;       // n_ops + 1
  std::vector<int32_t> in_producer;  // per edge, -1 = graph input
  std::vector<int32_t> in_rank;      // per edge
  std::vector<int64_t> in_shape;     // edges * MAXD
  std::vector<std::vector<int32_t>> out_edges;  // producer op -> edge ids

  // ---- mutable per-op rows (ffsim_update_op) ----
  std::vector<OpRow> ops;
  std::vector<int32_t> nparts;

  // ---- cached per-edge link specs ----
  std::vector<std::vector<Link>> links;
  std::vector<char> edge_valid;

  // ---- dirty tracking since the last assembly / replay ----
  std::vector<char> op_struct_dirty;  // dims/devs changed -> re-assemble
  std::vector<char> op_time_dirty;    // fwd/bwd changed   -> delta repair
  std::vector<char> op_sync_dirty;    // sync changed (matters if overlap)
  bool any_struct = false, any_time = false, any_sync = false;
  // a sync cost crossing zero changes the overlap-mode TASK SET (an
  // update task appears/disappears), not just a run time — re-assemble
  bool any_sync_flip = false;

  // ---- assembled task graph (valid when `assembled`) ----
  bool assembled = false;
  int32_t overlap_built = -1;
  std::vector<double> run_time;
  std::vector<int32_t> device;
  std::vector<std::vector<int32_t>> next;
  std::vector<std::vector<int32_t>> preds;
  std::vector<int32_t> base_indeg;
  std::vector<int32_t> f0, b0;        // per op: first fwd / bwd task id
  std::vector<int32_t> upd_task;      // per op: update task id or -1

  // ---- cached event-loop results (valid when `have_times`) ----
  bool have_times = false;
  std::vector<double> c_ready, c_end;
  std::vector<int32_t> pop_order;           // pops in order (a topo order)
  std::vector<int32_t> dev_prev, dev_next;  // device-queue neighbours
  std::vector<int32_t> dev_last;            // per device: last task or -1

  // ---- stats (ffsim_stat) ----
  int64_t stat_edge_rebuilds = 0;  // link specs recomputed
  int64_t stat_full_replays = 0;   // full event-loop passes
  int64_t stat_repairs = 0;        // downstream-only delta repairs
  int64_t stat_fallbacks = 0;      // repairs aborted to a full replay
  int64_t stat_assemblies = 0;     // task-graph (re)assemblies
};

// ------------------------------------------------------------------
// link-spec construction: one edge's producer/consumer rect sweep
// (identical maths to the pre-stateful ffsim_simulate edge loop)
void build_links(SimState& st, int e, int op) {
  std::vector<Link>& out = st.links[e];
  out.clear();
  int prod = st.in_producer[e];
  if (prod < 0) {
    st.edge_valid[e] = 1;
    return;
  }
  int rk = st.rank[op];
  const int64_t* dims = st.ops[op].dims;
  int prk = st.rank[prod];
  const int64_t* pshape = &st.out_shape[prod * MAXD];
  const int64_t* pdims = st.ops[prod].dims;
  int irk = st.in_rank[e];
  const int64_t* ishape = &st.in_shape[(size_t)e * MAXD];
  // consumer input partition degrees: project consumer dims onto the
  // input rank, degenerating to 1 where the extent doesn't divide
  // (simulator.py consumer-rect projection)
  int64_t in_dims[MAXD];
  for (int i = 0; i < irk; i++) {
    int64_t d = (i < rk) ? dims[i] : 1;
    if (d < 1) d = 1;
    in_dims[i] = (ishape[i] % d == 0) ? std::min<int64_t>(d, ishape[i]) : 1;
  }
  // the Python reference zips coord with in_dims, truncating the
  // consumer rect to min(consumer rank, input rank) dims; comm volume
  // then spans min(producer rank, that) dims — mirror exactly
  int cr = std::min(rk, irk);
  int64_t coord[MAXD] = {0, 0, 0, 0};
  for (int p = 0; p < st.nparts[op]; p++) {
    int64_t ccoord[MAXD];
    for (int i = 0; i < cr; i++) ccoord[i] = coord[i] % in_dims[i];
    Rect crect;
    part_rect(ishape, in_dims, ccoord, cr, &crect);
    int64_t pcoord[MAXD] = {0, 0, 0, 0};
    for (int q = 0; q < st.nparts[prod]; q++) {
      Rect prect;
      part_rect(pshape, pdims, pcoord, prk, &prect);
      int mr = std::min(prk, cr);
      int64_t vol = overlap_volume(prect, crect, mr);
      if (vol > 0) out.push_back(Link{p, q, (double)vol});
      next_coord(pcoord, pdims, prk);
    }
    next_coord(coord, dims, rk);
  }
  st.edge_valid[e] = 1;
  st.stat_edge_rebuilds++;
}

inline int task_dev(const SimState& st, int op, int part) {
  const OpRow& r = st.ops[op];
  int nd = (int)r.devs.size();
  return r.devs[part % nd] % st.num_devices;
}

int add_task(SimState& st, double rt, int dev) {
  st.run_time.push_back(rt);
  st.device.push_back(dev);
  st.next.emplace_back();
  return (int)st.run_time.size() - 1;
}

// ------------------------------------------------------------------
// task assembly from cached rows + link specs.  Task ids, edge-add order
// and therefore every heap tie-break reproduce the pre-stateful builder
// exactly — the one-shot and stateful paths are bit-identical.
void assemble(SimState& st, int overlap) {
  st.run_time.clear();
  st.device.clear();
  st.next.clear();
  st.f0.assign(st.n_ops, 0);
  st.b0.assign(st.n_ops, 0);
  st.upd_task.assign(st.n_ops, -1);

  // 1) forward + backward tasks per partition; bwd waits on own fwd
  for (int op = 0; op < st.n_ops; op++) {
    const OpRow& r = st.ops[op];
    st.f0[op] = (int)st.run_time.size();
    for (int p = 0; p < st.nparts[op]; p++)
      add_task(st, r.fwd, task_dev(st, op, p));
    st.b0[op] = (int)st.run_time.size();
    for (int p = 0; p < st.nparts[op]; p++)
      add_task(st, r.bwd, task_dev(st, op, p));
    for (int p = 0; p < st.nparts[op]; p++)
      st.next[st.f0[op] + p].push_back(st.b0[op] + p);
  }

  // 2) dependency + comm edges from the cached link specs
  for (int op = 0; op < st.n_ops; op++) {
    for (int e = st.in_off[op]; e < st.in_off[op + 1]; e++) {
      int prod = st.in_producer[e];
      if (prod < 0) continue;
      for (const Link& lk : st.links[e]) {
        int dev = task_dev(st, op, lk.p);
        int pdev = task_dev(st, prod, lk.q);
        int cf = st.f0[op] + lk.p, cb = st.b0[op] + lk.p;
        int pf = st.f0[prod] + lk.q, pb = st.b0[prod] + lk.q;
        if (pdev != dev) {
          double nb = lk.vol * st.dtype_bytes;
          bool intra = (pdev / st.dps) == (dev / st.dps);
          double ct_time =
              transfer_time(nb, intra, st.ici_bw, st.dcn_bw, st.latency);
          int ct = add_task(st, ct_time, pdev);
          st.next[pf].push_back(ct);
          st.next[ct].push_back(cf);
          int ct2 = add_task(st, ct_time, dev);
          st.next[cb].push_back(ct2);
          st.next[ct2].push_back(pb);
        } else {
          st.next[pf].push_back(cf);
          st.next[cb].push_back(pb);
        }
      }
    }
  }

  // 3) overlapped weight-sync tasks (bulk-synchronous sync is summed at
  // simulate time so a sync-only change never dirties the graph)
  if (overlap) {
    for (int op = 0; op < st.n_ops; op++) {
      if (st.ops[op].sync <= 0.0) continue;
      int ut = add_task(st, st.ops[op].sync, 0);
      st.upd_task[op] = ut;
      for (int p = 0; p < st.nparts[op]; p++)
        st.next[st.b0[op] + p].push_back(ut);
    }
  }

  // predecessor lists + indegrees (repair + replay bookkeeping)
  size_t T = st.run_time.size();
  st.preds.assign(T, {});
  st.base_indeg.assign(T, 0);
  for (size_t t = 0; t < T; t++)
    for (int n : st.next[t]) {
      st.preds[n].push_back((int)t);
      st.base_indeg[n]++;
    }

  st.assembled = true;
  st.overlap_built = overlap;
  st.have_times = false;
  st.stat_assemblies++;
  std::fill(st.op_struct_dirty.begin(), st.op_struct_dirty.end(), 0);
  st.any_struct = false;
  st.any_sync_flip = false;
}

// ------------------------------------------------------------------
// full event-driven replay (priority queue over ready tasks); ties broken
// by push order, matching the Python reference's monotonically-increasing
// heap uid.  Also records the caches the delta repair consumes: per-task
// ready/end, the pop order (a topological order over dependency AND
// device-queue edges) and per-device queue neighbours.
double full_replay(SimState& st) {
  size_t T = st.run_time.size();
  st.c_ready.assign(T, 0.0);
  st.c_end.assign(T, 0.0);
  st.pop_order.clear();
  st.pop_order.reserve(T);
  st.dev_prev.assign(T, -1);
  st.dev_next.assign(T, -1);
  st.dev_last.assign(st.num_devices, -1);

  struct QE {
    double ready;
    int64_t seq;
    int task;
    bool operator>(const QE& o) const {
      return ready != o.ready ? ready > o.ready : seq > o.seq;
    }
  };
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  std::vector<int32_t> indeg = st.base_indeg;
  std::vector<double> ready(T, 0.0);
  std::vector<double> dev_free(st.num_devices, 0.0);
  int64_t seq = 0;
  for (size_t i = 0; i < T; i++)
    if (indeg[i] == 0) heap.push({0.0, seq++, (int)i});
  double finish = 0.0;
  size_t processed = 0;
  while (!heap.empty()) {
    QE e = heap.top();
    heap.pop();
    int t = e.task;
    double start = std::max(e.ready, dev_free[st.device[t]]);
    double end = start + st.run_time[t];
    dev_free[st.device[t]] = end;
    if (end > finish) finish = end;
    processed++;
    st.c_ready[t] = e.ready;
    st.c_end[t] = end;
    st.pop_order.push_back(t);
    int prev = st.dev_last[st.device[t]];
    st.dev_prev[t] = prev;
    if (prev >= 0) st.dev_next[prev] = t;
    st.dev_last[st.device[t]] = t;
    for (int ni : st.next[t]) {
      if (end > ready[ni]) ready[ni] = end;
      if (--indeg[ni] == 0) heap.push({ready[ni], seq++, ni});
    }
  }
  st.stat_full_replays++;
  if (processed != T) {
    st.have_times = false;
    return 1e30;  // cycle
  }
  st.have_times = true;
  std::fill(st.op_time_dirty.begin(), st.op_time_dirty.end(), 0);
  std::fill(st.op_sync_dirty.begin(), st.op_sync_dirty.end(), 0);
  st.any_time = st.any_sync = false;
  return finish;
}

// ------------------------------------------------------------------
// downstream-only delta repair for time-only changes.  Walks the cached
// pop order (a topological order), re-simulating only the dirty frontier;
// a task whose end time is unchanged stops the propagation.  Exact by
// construction: device-queue pop order depends only on ready times (pops
// happen at readiness, device contention delays starts, not pops), so as
// long as every repaired task's new ready stays STRICTLY between its
// device-queue neighbours' readies, the full event loop would schedule
// the identical order — any tie or inversion aborts to a full replay.
// Returns false on fallback.
bool delta_repair(SimState& st, double* out_finish) {
  size_t T = st.run_time.size();
  size_t cap = (size_t)std::max(1.0, st.threshold * (double)T);
  std::vector<char> dirty(T, 0);
  size_t seeded = 0;
  for (int op = 0; op < st.n_ops; op++) {
    if (st.op_time_dirty[op]) {
      for (int p = 0; p < st.nparts[op]; p++) {
        dirty[st.f0[op] + p] = 1;
        dirty[st.b0[op] + p] = 1;
        seeded += 2;
      }
      for (int p = 0; p < st.nparts[op]; p++) {
        st.run_time[st.f0[op] + p] = st.ops[op].fwd;
        st.run_time[st.b0[op] + p] = st.ops[op].bwd;
      }
    }
    if (st.op_sync_dirty[op] && st.overlap_built && st.upd_task[op] >= 0) {
      dirty[st.upd_task[op]] = 1;
      st.run_time[st.upd_task[op]] = st.ops[op].sync;
      seeded++;
    }
  }
  if (seeded > cap) {
    st.stat_fallbacks++;
    return false;
  }
  // snapshot of the pre-repair ready times: the order guard must judge
  // "was this pair tied BEFORE?" against them even after neighbours
  // have been repaired in place
  std::vector<double> old_ready = st.c_ready;
  size_t repaired = 0;
  for (int t : st.pop_order) {
    if (!dirty[t]) continue;
    if (++repaired > cap) {
      st.stat_fallbacks++;
      return false;
    }
    double r = 0.0;
    for (int p : st.preds[t])
      if (st.c_end[p] > r) r = st.c_end[p];
    // Order-preservation guard.  Pop order is a function of ready times
    // and push order alone, and push order follows the pop prefix and
    // the static next lists — so by induction over the pop sequence the
    // cached order stays valid as long as every repaired task keeps its
    // ORDER RELATION to its device-queue neighbours (device queues pop
    // in ready-sorted order, ties broken by push order):
    //   * strictly between the neighbours' ready times -> position
    //     pinned;
    //   * tied with a neighbour it was ALREADY tied with -> the old
    //     push-order tie-break still applies (pushes replay in the
    //     same order);
    //   * a NEW tie or an inversion -> the tie-break depends on
    //     within-timestamp event interleaving we cannot cheaply
    //     reproduce — fall back to a full replay.
    // A task whose ready is unchanged keeps its relations by
    // construction and skips the guard.  Every adjacent pair is checked
    // by whichever member repairs LAST, so deferred shifts are caught.
    int dp = st.dev_prev[t], dn = st.dev_next[t];
    if (r != old_ready[t]) {
      if (dp >= 0 && !(st.c_ready[dp] < r ||
                       (st.c_ready[dp] == r &&
                        old_ready[dp] == old_ready[t]))) {
        st.stat_fallbacks++;
        return false;
      }
      if (dn >= 0 && !(r < st.c_ready[dn] ||
                       (r == st.c_ready[dn] &&
                        old_ready[t] == old_ready[dn]))) {
        st.stat_fallbacks++;
        return false;
      }
    }
    double start = std::max(r, dp >= 0 ? st.c_end[dp] : 0.0);
    double end = start + st.run_time[t];
    st.c_ready[t] = r;
    if (end != st.c_end[t]) {
      st.c_end[t] = end;
      for (int ni : st.next[t]) dirty[ni] = 1;
      if (dn >= 0) dirty[dn] = 1;
    }
  }
  double finish = 0.0;
  for (int d = 0; d < st.num_devices; d++)
    if (st.dev_last[d] >= 0 && st.c_end[st.dev_last[d]] > finish)
      finish = st.c_end[st.dev_last[d]];
  st.stat_repairs++;
  std::fill(st.op_time_dirty.begin(), st.op_time_dirty.end(), 0);
  std::fill(st.op_sync_dirty.begin(), st.op_sync_dirty.end(), 0);
  st.any_time = st.any_sync = false;
  *out_finish = finish;
  return true;
}

double state_simulate(SimState& st, int overlap) {
  for (int op = 0; op < st.n_ops; op++) {
    const OpRow& r = st.ops[op];
    if (!r.init || !std::isfinite(r.fwd) || !std::isfinite(r.bwd))
      return 1e30;
  }
  if (st.any_struct || !st.assembled || st.overlap_built != overlap ||
      (overlap && st.any_sync_flip)) {
    for (int e = 0; e < (int)st.in_producer.size(); e++)
      if (!st.edge_valid[e]) {
        // edge index -> consumer op (in_off is sorted)
        int op = (int)(std::upper_bound(st.in_off.begin(), st.in_off.end(), e)
                       - st.in_off.begin()) - 1;
        build_links(st, e, op);
      }
    assemble(st, overlap);
  }
  double finish;
  if (st.have_times && !st.any_time && !st.any_sync) {
    // nothing in the task graph changed — cached makespan
    finish = 0.0;
    for (int d = 0; d < st.num_devices; d++)
      if (st.dev_last[d] >= 0 && st.c_end[st.dev_last[d]] > finish)
        finish = st.c_end[st.dev_last[d]];
  } else if (st.have_times && delta_repair(st, &finish)) {
    // downstream-only repair succeeded
  } else {
    finish = full_replay(st);
    if (finish >= 1e29) return 1e30;
  }
  double update_total = 0.0;
  if (!overlap)
    for (int op = 0; op < st.n_ops; op++)
      if (st.ops[op].sync > 0.0) update_total += st.ops[op].sync;
  return finish + update_total;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------
// stateful API — marshal once per (mesh, model), update per proposal
void* ffsim_create(int32_t n_ops, int32_t num_devices,
                   int32_t devices_per_slice,
                   const int32_t* rank,        // n_ops output ranks
                   const int64_t* out_shape,   // n_ops * MAXD
                   const int32_t* in_off,      // n_ops + 1
                   const int32_t* in_producer, // producing op index or -1
                   const int32_t* in_rank,     // rank of each input tensor
                   const int64_t* in_shape,    // n_inputs * MAXD
                   double ici_bw, double dcn_bw, double latency,
                   double dtype_bytes, double threshold) {
  SimState* st = new SimState();
  st->n_ops = n_ops;
  st->num_devices = num_devices;
  st->dps = devices_per_slice;
  st->ici_bw = ici_bw;
  st->dcn_bw = dcn_bw;
  st->latency = latency;
  st->dtype_bytes = dtype_bytes;
  st->threshold = threshold > 0 ? threshold : 0.25;
  st->rank.assign(rank, rank + n_ops);
  st->out_shape.assign(out_shape, out_shape + (size_t)n_ops * MAXD);
  st->in_off.assign(in_off, in_off + n_ops + 1);
  int n_in = in_off[n_ops];
  st->in_producer.assign(in_producer, in_producer + n_in);
  st->in_rank.assign(in_rank, in_rank + n_in);
  st->in_shape.assign(in_shape, in_shape + (size_t)n_in * MAXD);
  st->out_edges.assign(n_ops, {});
  for (int e = 0; e < n_in; e++)
    if (st->in_producer[e] >= 0) st->out_edges[st->in_producer[e]].push_back(e);
  st->ops.assign(n_ops, OpRow());
  st->nparts.assign(n_ops, 1);
  st->links.assign(n_in, {});
  st->edge_valid.assign(n_in, 0);
  st->op_struct_dirty.assign(n_ops, 0);
  st->op_time_dirty.assign(n_ops, 0);
  st->op_sync_dirty.assign(n_ops, 0);
  return st;
}

// Replace one op's row.  dims is MAXD int64 partition degrees (padded
// with 1s); dev_ids lists the op's raw device ids.  Returns 1 when the
// partition STRUCTURE changed (dims/devices), 0 for a time-only change.
int32_t ffsim_update_op(void* h, int32_t op, double fwd, double bwd,
                        double sync, const int64_t* dims, int32_t n_dev,
                        const int32_t* dev_ids) {
  SimState& st = *(SimState*)h;
  OpRow& r = st.ops[op];
  bool structural = !r.init;
  if (!structural) {
    for (int i = 0; i < MAXD; i++)
      if (r.dims[i] != dims[i]) structural = true;
    if ((int32_t)r.devs.size() != n_dev)
      structural = true;
    else
      for (int i = 0; i < n_dev; i++)
        if (r.devs[i] != dev_ids[i]) structural = true;
  }
  if (!structural && (r.fwd != fwd || r.bwd != bwd)) {
    st.op_time_dirty[op] = 1;
    st.any_time = true;
  }
  if (!structural && r.sync != sync) {
    st.op_sync_dirty[op] = 1;
    st.any_sync = true;
    if ((r.sync <= 0.0) != (sync <= 0.0)) st.any_sync_flip = true;
  }
  r.fwd = fwd;
  r.bwd = bwd;
  r.sync = sync;
  std::memcpy(r.dims, dims, sizeof(int64_t) * MAXD);
  r.devs.assign(dev_ids, dev_ids + n_dev);
  r.init = true;
  if (structural) {
    int64_t np = 1;
    for (int i = 0; i < st.rank[op]; i++) np *= r.dims[i];
    st.nparts[op] = (int32_t)np;
    st.op_struct_dirty[op] = 1;
    st.any_struct = true;
    // invalidate the link specs of every edge touching this op — the
    // delta frontier of the proposal
    for (int e = st.in_off[op]; e < st.in_off[op + 1]; e++)
      st.edge_valid[e] = 0;
    for (int e : st.out_edges[op]) st.edge_valid[e] = 0;
  }
  return structural ? 1 : 0;
}

// Simulated iteration time (seconds) from the current rows, or 1e30 for
// a cyclic graph / uninitialized or non-finite rows.
double ffsim_state_simulate(void* h, int32_t overlap_backward_update) {
  return state_simulate(*(SimState*)h, overlap_backward_update);
}

void ffsim_destroy(void* h) { delete (SimState*)h; }

// Introspection for tests and search-bench:
//   0: link-spec rebuilds   1: full replays    2: delta repairs
//   3: repair fallbacks     4: task count      5: assemblies
int64_t ffsim_stat(void* h, int32_t which) {
  SimState& st = *(SimState*)h;
  switch (which) {
    case 0: return st.stat_edge_rebuilds;
    case 1: return st.stat_full_replays;
    case 2: return st.stat_repairs;
    case 3: return st.stat_fallbacks;
    case 4: return (int64_t)st.run_time.size();
    case 5: return st.stat_assemblies;
  }
  return -1;
}

// ------------------------------------------------------------------
// one-shot ABI (pre-stateful callers + parity tests): create a
// throwaway state, push every row, simulate once, destroy.
double ffsim_simulate(
    int32_t n_ops, int32_t num_devices, int32_t devices_per_slice,
    const double* fwd_time,       // per-part forward time
    const double* bwd_time,       // per-part backward time
    const double* sync_time,      // per-op weight allreduce time
    const int32_t* rank,          // output tensor rank
    const int64_t* out_shape,     // n_ops * MAXD
    const int64_t* out_dims,      // n_ops * MAXD partition degrees
    const int32_t* dev_off,       // n_ops+1 offsets into dev_ids
    const int32_t* dev_ids,       // flattened per-part device ids
    const int32_t* in_off,        // n_ops+1 offsets into input arrays
    const int32_t* in_producer,   // producing op index or -1 (graph input)
    const int32_t* in_rank,       // rank of each input tensor
    const int64_t* in_shape,      // n_inputs * MAXD
    int32_t overlap_backward_update,
    double ici_bw, double dcn_bw, double latency, double dtype_bytes) {
  void* h = ffsim_create(n_ops, num_devices, devices_per_slice, rank,
                         out_shape, in_off, in_producer, in_rank, in_shape,
                         ici_bw, dcn_bw, latency, dtype_bytes, 0.25);
  for (int op = 0; op < n_ops; op++)
    ffsim_update_op(h, op, fwd_time[op], bwd_time[op], sync_time[op],
                    &out_dims[op * MAXD], dev_off[op + 1] - dev_off[op],
                    &dev_ids[dev_off[op]]);
  double t = ffsim_state_simulate(h, overlap_backward_update);
  ffsim_destroy(h);
  return t;
}

int32_t ffsim_version() { return 2; }

}  // extern "C"
