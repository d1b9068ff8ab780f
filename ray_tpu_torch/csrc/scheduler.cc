// Native cluster-resource scheduler: fixed-point resources + hybrid policy.
//
// C++ analog of the reference's raylet scheduling core
// (/root/reference/src/ray/raylet/scheduling/cluster_resource_scheduler.h:45,
// policy/hybrid_scheduling_policy.h:48, fixed_point.h): resource quantities
// are int64 milli-units (exact arithmetic, no float drift when packing
// fractional CPUs), node views live in one flat table, and the hybrid policy
// prefers the local node until its utilization crosses a threshold, then
// spills to the top-k best-utilization feasible nodes deterministically.
//
// Exposed as a C ABI (ctypes-loaded from ray_tpu/_core/scheduler.py); the
// GCS actor scheduler uses it when built, with a pure-Python fallback
// mirroring the semantics (same test suite runs against both).
//
// Thread-safety: one mutex over the node table — scheduling decisions are
// O(nodes * resources) table scans, far from any contention concern at the
// control-plane rates involved.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

constexpr int64_t kMilli = 1000;  // fixed-point scale (fixed_point.h analog)

struct Node {
  // resource name -> milli-units
  std::map<std::string, int64_t> total;
  std::map<std::string, int64_t> available;
  bool alive = true;
};

struct Scheduler {
  std::mutex mu;
  std::map<std::string, Node> nodes;
  double spill_threshold = 0.5;  // hybrid_threshold (ray_config_def.h
                                 // scheduler_spread_threshold default)
  int top_k = 1;
};

// demand/capacity wire format: a flat array of (name, milli) pairs encoded
// as "name\0" strings + int64 array, kept simple: we parse a single packed
// buffer "name=milli;name=milli;..." to avoid multi-array ABI juggling.
std::map<std::string, int64_t> ParseDemand(const char* packed) {
  std::map<std::string, int64_t> out;
  if (packed == nullptr) return out;
  const char* p = packed;
  while (*p) {
    const char* eq = std::strchr(p, '=');
    if (!eq) break;
    const char* sep = std::strchr(eq + 1, ';');
    std::string name(p, eq - p);
    int64_t v = std::strtoll(eq + 1, nullptr, 10);
    out[name] = v;
    if (!sep) break;
    p = sep + 1;
  }
  return out;
}

bool Feasible(const Node& n, const std::map<std::string, int64_t>& demand,
              bool against_total) {
  const auto& cap = against_total ? n.total : n.available;
  for (const auto& [name, need] : demand) {
    if (need <= 0) continue;
    auto it = cap.find(name);
    if (it == cap.end() || it->second < need) return false;
  }
  return true;
}

// "critical resource utilization" after hypothetically placing the demand
// (hybrid_scheduling_policy.cc HybridPolicyWithFarthestNode scoring).
double Utilization(const Node& n, const std::map<std::string, int64_t>& demand) {
  double worst = 0.0;
  for (const auto& [name, tot] : n.total) {
    if (tot <= 0) continue;
    int64_t avail = 0;
    auto it = n.available.find(name);
    if (it != n.available.end()) avail = it->second;
    auto dit = demand.find(name);
    int64_t need = dit == demand.end() ? 0 : dit->second;
    double used = static_cast<double>(tot - avail + need);
    worst = std::max(worst, used / static_cast<double>(tot));
  }
  return worst;
}

}  // namespace

extern "C" {

void* sched_create(double spill_threshold, int top_k) {
  auto* s = new Scheduler();
  s->spill_threshold = spill_threshold;
  s->top_k = std::max(top_k, 1);
  return s;
}

void sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

void sched_update_node(void* h, const char* node_id, const char* total,
                       const char* available, int alive) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  Node& n = s->nodes[node_id];
  n.total = ParseDemand(total);
  n.available = ParseDemand(available);
  n.alive = alive != 0;
}

void sched_remove_node(void* h, const char* node_id) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  s->nodes.erase(node_id);
}

int64_t sched_num_nodes(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return static_cast<int64_t>(s->nodes.size());
}

// Pick the best node for `demand`. Returns 1 and writes the chosen node id
// into out (out_len bytes) on success; 0 if no feasible node. `local_id`
// may be empty. `spread` != 0 selects the spread policy (most-available
// first) instead of hybrid packing.
int sched_best_node(void* h, const char* demand_packed, const char* local_id,
                    int spread, int64_t seed, char* out, int64_t out_len) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto demand = ParseDemand(demand_packed);

  // local-first: if the local node is feasible and under the threshold,
  // keep the task here (hybrid policy's top preference).
  if (!spread && local_id != nullptr && *local_id) {
    auto it = s->nodes.find(local_id);
    if (it != s->nodes.end() && it->second.alive &&
        Feasible(it->second, demand, /*against_total=*/false) &&
        Utilization(it->second, demand) <= s->spill_threshold) {
      std::strncpy(out, local_id, out_len - 1);
      out[out_len - 1] = '\0';
      return 1;
    }
  }

  std::vector<std::pair<double, const std::string*>> scored;
  for (const auto& [id, n] : s->nodes) {
    if (!n.alive || !Feasible(n, demand, false)) continue;
    double u = Utilization(n, demand);
    // hybrid: lowest post-placement utilization wins (pack under the
    // threshold, spread above it); spread: most headroom first — same key.
    scored.emplace_back(u, &id);
  }
  if (scored.empty()) return 0;
  std::sort(scored.begin(), scored.end(),
            [](const auto& a, const auto& b) {
              if (a.first != b.first) return a.first < b.first;
              return *a.second < *b.second;  // deterministic tie-break
            });
  // deterministic rotation over the top-k equally-good candidates so
  // concurrent requests don't all pile onto one node
  int64_t k = std::min<int64_t>(s->top_k, scored.size());
  const std::string* chosen = scored[seed % k].second;
  std::strncpy(out, chosen->c_str(), out_len - 1);
  out[out_len - 1] = '\0';
  return 1;
}

// Feasibility check against *total* capacity — lets the GCS distinguish
// "pending, resources busy" from "infeasible until the cluster grows"
// (the autoscaler scales from pending demand, so neither fails fast).
int sched_feasible_anywhere(void* h, const char* demand_packed) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto demand = ParseDemand(demand_packed);
  for (const auto& [id, n] : s->nodes) {
    (void)id;
    if (n.alive && Feasible(n, demand, /*against_total=*/true)) return 1;
  }
  return 0;
}

}  // extern "C"
