// Native simulated-annealing planner search (host code).
//
// The contraction-order search (greedy-seeded trees + SA local rewrites +
// the dynamic-slicing loop) is the planner's hot loop: O(V) tree sweeps x
// iters x betas x trials.  The Python implementation
// (artensor_tpu_torch/planner/{tree,annealing}.py) is the reference
// semantics; this file reimplements it on flat arrays with sorted-vector
// boundary merges and runs all trials on C++ threads in one call.  It is
// the JAX package's search, line for line, with one more parameter of the
// roofline objective (its per-step overhead floor) in the C ABI.
//
// Exposed via a plain C ABI (ctypes-loaded; no pybind11 dependency).
// Cost-model formulas match planner/cost.py exactly:
//   tc = log2 prod(all bond dims) [-1 if outer product] + mfactor
//   sc = log2 prod(result bond dims) + mfactor
//   mfactor = min(log2_max_bitstring, mf_left + mf_right)
//   mc = log2sumexp2 of operand/result scs (batch-aligned when combined
//        mfactor overflows the budget)
//   score = log10(alpha*10^mc + 10^tc) + 2*log10(2)*max(0, sc - sc_target)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Network {
    int n_tensors = 0;
    int n_bonds = 0;
    std::vector<std::vector<int>> tensor_bonds;  // bond ids per tensor
    std::vector<double> log2dim;                 // per bond
    std::vector<int> degree;                     // live degree per bond
    std::vector<uint8_t> is_final;
    std::vector<uint8_t> sliced;                 // bond currently sliced?
    double log2_max_bitstring = 0.0;
};

struct Node {
    int left = -1, right = -1, parent = -1;
    int leaf_id = -1;
    double tc = 0, sc = 0, mc = 0, mfactor = 0, nfq = 0;
    // boundary bonds (sorted) with subtree refcounts
    std::vector<int> bonds;
    std::vector<int> counts;
    std::vector<int> contract;  // bonds eliminated at this node (sorted)

    bool leaf() const { return leaf_id >= 0; }
    bool has_bond(int b) const {
        return std::binary_search(bonds.begin(), bonds.end(), b) ||
               std::binary_search(contract.begin(), contract.end(), b);
    }
};

double log2sumexp2(const double* v, int n) {
    if (n == 0) return 0.0;
    double m = v[0];
    for (int i = 1; i < n; i++) m = std::max(m, v[i]);
    double s = 0.0;
    for (int i = 0; i < n; i++) s += std::exp2(v[i] - m);
    return m + std::log2(s);
}

const double LOG10_2 = std::log10(2.0);

// device roofline objective (objective = 1): per-step cost is
// max(compute at the K-discounted product rate, memory traffic) + fixed
// overhead, summed over internal nodes and multiplied by 2^(#sliced
// bonds).  The caller passes every parameter (planner/cost.py's H100
// figures) through the C ABI; the defaults below are those figures.
struct RoofParams {
    double muladds_per_s = 495e12 / 3.0 / 8.0;  // 3xTF32, complex
    double bytes_per_s = 3.35e12;
    double step_ov = 0.0;        // per-step floor
    double step_ov_w1 = 323e-6;  // fixed per-step cost at slice width 1
    double hbm_budget = 60e9;    // usable bytes for the slice-width batch
    double k_full = 8.0;         // contraction width at the full product
                                 // rate (the mma k-step); a LARGER value
                                 // biases the search toward wide-K trees
};

// the slice width the plan can afford: budget / (8 bytes * live set),
// where live set = 2^mc (mc in log2).  Small steps carry step_ov_w1 of
// fixed cost amortized by the width.
double width_overhead(double mc_log2, int n_steps, const RoofParams& rp) {
    double width = rp.hbm_budget / (8.0 * std::exp2(mc_log2));
    width = std::max(1.0, std::min(width, 256.0));
    double ov = std::max(rp.step_ov, rp.step_ov_w1 / width);
    return ov * n_steps;
}

double node_roof(const Node& v, const Node& L, const Node& R,
                 const RoofParams& rp) {
    double k = std::exp2(std::max(0.0, v.tc - v.sc));
    double rate = rp.muladds_per_s * std::min(1.0, k / rp.k_full);
    double compute = std::exp2(v.tc) / rate;
    double traffic = 8.0 * (std::exp2(L.sc) + std::exp2(R.sc)
                            + std::exp2(v.sc)) / rp.bytes_per_s;
    return std::max(compute, traffic);
}

double score_fn(double tc, double sc, double mc, double sc_target, double alpha) {
    double body;
    if (alpha > 0.0) {
        double a = mc + std::log10(alpha), b = tc;
        double m = std::max(a, b);
        body = m + std::log10(std::pow(10.0, a - m) + std::pow(10.0, b - m));
    } else {
        body = tc;
    }
    return body + 2.0 * LOG10_2 * std::max(0.0, sc - sc_target);
}

struct Tree {
    const Network* net;
    Network live;                 // degrees/tensor bonds mutate with slicing
    std::vector<Node> nodes;      // leaves [0, n_tensors), internals after
    std::vector<int> leaf_of;     // tensor id -> node index (identity)
    int root = -1;
    std::vector<int> sliced_bonds;

    void init(const Network& n) {
        net = &n;
        live = n;  // copy
        nodes.clear();
        nodes.resize(n.n_tensors);
        leaf_of.resize(n.n_tensors);
        for (int t = 0; t < n.n_tensors; t++) {
            leaf_of[t] = t;
            refresh_leaf(t);
        }
        sliced_bonds.clear();
    }

    void refresh_leaf(int idx) {
        Node& nd = nodes[idx];
        nd.leaf_id = idx;
        nd.left = nd.right = -1;
        nd.bonds = live.tensor_bonds[idx];
        std::sort(nd.bonds.begin(), nd.bonds.end());
        nd.counts.assign(nd.bonds.size(), 1);
        nd.contract.clear();
        nd.nfq = live.is_final[idx] ? 1.0 : 0.0;
        nd.mfactor = std::min(live.log2_max_bitstring, nd.nfq);
        double s = 0;
        for (int b : nd.bonds) s += live.log2dim[b];
        nd.tc = 0.0;
        nd.sc = s + nd.mfactor;
        nd.mc = 0.0;
    }

    void refresh_internal(int idx) {
        Node& nd = nodes[idx];
        const Node& L = nodes[nd.left];
        const Node& R = nodes[nd.right];
        nd.leaf_id = -1;
        nd.nfq = L.nfq + R.nfq;
        double combined = L.mfactor + R.mfactor;
        nd.mfactor = std::min(live.log2_max_bitstring, combined);
        nd.bonds.clear();
        nd.counts.clear();
        nd.contract.clear();
        double log2_all = 0, log2_out = 0;
        size_t i = 0, j = 0;
        bool any_contract = false;
        while (i < L.bonds.size() || j < R.bonds.size()) {
            int b;
            int c;
            if (j >= R.bonds.size() || (i < L.bonds.size() && L.bonds[i] < R.bonds[j])) {
                b = L.bonds[i]; c = L.counts[i]; i++;
            } else if (i >= L.bonds.size() || R.bonds[j] < L.bonds[i]) {
                b = R.bonds[j]; c = R.counts[j]; j++;
            } else {
                b = L.bonds[i]; c = L.counts[i] + R.counts[j]; i++; j++;
                if (c == live.degree[b]) {
                    nd.contract.push_back(b);
                    log2_all += live.log2dim[b];
                    any_contract = true;
                    continue;
                }
            }
            log2_all += live.log2dim[b];
            log2_out += live.log2dim[b];
            nd.bonds.push_back(b);
            nd.counts.push_back(c);
        }
        nd.tc = (any_contract ? log2_all : log2_all - 1.0) + nd.mfactor;
        nd.sc = log2_out + nd.mfactor;
        double scs[3];
        if (combined > live.log2_max_bitstring) {
            scs[0] = L.sc - L.mfactor + nd.mfactor;
            scs[1] = R.sc - R.mfactor + nd.mfactor;
        } else {
            scs[0] = L.sc;
            scs[1] = R.sc;
        }
        scs[2] = nd.sc;
        nd.mc = log2sumexp2(scs, 3);
    }

    // build from order over representative ids (pair (i, j): j merged into i)
    void build(const int* order, int n_pairs) {
        nodes.resize(net->n_tensors);
        for (int t = 0; t < net->n_tensors; t++) refresh_leaf(t);
        std::vector<int> branch(net->n_tensors);
        for (int t = 0; t < net->n_tensors; t++) branch[t] = t;
        nodes.reserve(net->n_tensors + n_pairs);
        for (int p = 0; p < n_pairs; p++) {
            int a = branch[order[2 * p]];
            int b = branch[order[2 * p + 1]];
            Node nd;
            nd.left = a;
            nd.right = b;
            int idx = (int)nodes.size();
            nodes.push_back(std::move(nd));
            nodes[a].parent = idx;
            nodes[b].parent = idx;
            refresh_internal(idx);
            branch[order[2 * p]] = idx;
            root = idx;
        }
    }

    // iterative traversals
    void preorder(std::vector<int>& out) const {
        out.clear();
        std::vector<int> stack{root};
        while (!stack.empty()) {
            int v = stack.back();
            stack.pop_back();
            out.push_back(v);
            if (!nodes[v].leaf()) {
                stack.push_back(nodes[v].left);
                stack.push_back(nodes[v].right);
            }
        }
    }

    void complexity(double& tc, double& sc, double& mc) const {
        std::vector<double> tcs, mcs;
        double scmax = -1e300;
        std::vector<int> order;
        preorder(order);
        for (int v : order) {
            scmax = std::max(scmax, nodes[v].sc);
            if (!nodes[v].leaf()) {
                tcs.push_back(nodes[v].tc);
                mcs.push_back(nodes[v].mc);
            }
        }
        tc = log2sumexp2(tcs.data(), (int)tcs.size()) * LOG10_2;
        sc = scmax;
        mc = log2sumexp2(mcs.data(), (int)mcs.size()) * LOG10_2;
    }

    double max_mc() const {
        double m = 0.0;
        for (const Node& nd : nodes)
            if (!nd.leaf()) m = std::max(m, nd.mc);
        return m;
    }

    double roofline(const RoofParams& rp) const {
        double total = 0.0;
        std::vector<int> order;
        preorder(order);
        for (int v : order) {
            const Node& nd = nodes[v];
            if (nd.leaf()) continue;
            total += node_roof(nd, nodes[nd.left], nodes[nd.right], rp);
        }
        return total;
    }

    // ---- local 3-leaf rewrites ----------------------------------------
    // frontier under v (size 3 when possible): [f0, f1, f2], internal child m
    bool local_frontier(int v, int f[3], int& branch) const {
        const Node& nd = nodes[v];
        if (nd.leaf()) return false;
        int l = nd.left, r = nd.right;
        if (!nodes[l].leaf()) {
            // BFS order: queue = [l, r]; pop l -> push ll, lr
            f[0] = r; f[1] = nodes[l].left; f[2] = nodes[l].right;
            branch = l;
            return true;
        }
        if (!nodes[r].leaf()) {
            f[0] = nodes[r].left; f[1] = nodes[r].right; f[2] = l;
            branch = r;
            return true;
        }
        return false;
    }

    int current_order3(int v, const int f[3], int branch) const {
        int a = nodes[branch].left, b = nodes[branch].right;
        int ia = (a == f[0]) ? 0 : (a == f[1]) ? 1 : 2;
        int ib = (b == f[0]) ? 0 : (b == f[1]) ? 1 : 2;
        if (ia > ib) std::swap(ia, ib);
        if (ia == 0 && ib == 2) return 0;  // [(0,2),(0,1)]
        if (ia == 0 && ib == 1) return 1;  // [(0,1),(0,2)]
        return 2;                          // [(1,2),(0,1)]
    }

    // evaluate what-if complexity of re-contracting frontier in a given
    // canonical order (0,1,2 as in current_order3) using scratch nodes
    void whatif_order3(const int f[3], int which, double& tc, double& sc,
                       double& mc, Node& s1, Node& s2,
                       const RoofParams* rp = nullptr,
                       double* local_roof = nullptr) {
        static const int pairs[3][4] = {
            {0, 2, 0, 1}, {0, 1, 0, 2}, {1, 2, 0, 1}};
        int tmp_first[3] = {f[0], f[1], f[2]};
        // first merge
        merge_into(s1, nodes[f[pairs[which][0]]], nodes[f[pairs[which][1]]]);
        // second merge: slot pairs[which][0] now holds s1
        const Node* slot[3] = {&nodes[f[0]], &nodes[f[1]], &nodes[f[2]]};
        slot[pairs[which][0]] = &s1;
        merge_into(s2, *slot[pairs[which][2]], *slot[pairs[which][3]]);
        if (local_roof) {
            *local_roof =
                node_roof(s1, nodes[f[pairs[which][0]]],
                          nodes[f[pairs[which][1]]], *rp) +
                node_roof(s2, *slot[pairs[which][2]],
                          *slot[pairs[which][3]], *rp);
        }
        (void)tmp_first;
        double tcs[2] = {s1.tc, s2.tc};
        double mcs[2] = {s1.mc, s2.mc};
        double scm = std::max(
            std::max(s1.sc, s2.sc),
            std::max(nodes[f[0]].sc, std::max(nodes[f[1]].sc, nodes[f[2]].sc)));
        tc = log2sumexp2(tcs, 2) * LOG10_2;
        sc = scm;
        mc = log2sumexp2(mcs, 2) * LOG10_2;
    }

    void merge_into(Node& out, const Node& L, const Node& R) {
        out.leaf_id = -1;
        out.nfq = L.nfq + R.nfq;
        double combined = L.mfactor + R.mfactor;
        out.mfactor = std::min(live.log2_max_bitstring, combined);
        out.bonds.clear();
        out.counts.clear();
        out.contract.clear();
        double log2_all = 0, log2_out = 0;
        size_t i = 0, j = 0;
        bool any_contract = false;
        while (i < L.bonds.size() || j < R.bonds.size()) {
            int b;
            int c;
            if (j >= R.bonds.size() || (i < L.bonds.size() && L.bonds[i] < R.bonds[j])) {
                b = L.bonds[i]; c = L.counts[i]; i++;
            } else if (i >= L.bonds.size() || R.bonds[j] < L.bonds[i]) {
                b = R.bonds[j]; c = R.counts[j]; j++;
            } else {
                b = L.bonds[i]; c = L.counts[i] + R.counts[j]; i++; j++;
                if (c == live.degree[b]) {
                    out.contract.push_back(b);
                    log2_all += live.log2dim[b];
                    any_contract = true;
                    continue;
                }
            }
            log2_all += live.log2dim[b];
            log2_out += live.log2dim[b];
            out.bonds.push_back(b);
            out.counts.push_back(c);
        }
        out.tc = (any_contract ? log2_all : log2_all - 1.0) + out.mfactor;
        out.sc = log2_out + out.mfactor;
        double scs[3];
        if (combined > live.log2_max_bitstring) {
            scs[0] = L.sc - L.mfactor + out.mfactor;
            scs[1] = R.sc - R.mfactor + out.mfactor;
        } else {
            scs[0] = L.sc;
            scs[1] = R.sc;
        }
        scs[2] = out.sc;
        out.mc = log2sumexp2(scs, 3);
    }

    // rewire the subtree under v (with internal child `branch`) to `which`
    void apply_order3(int v, const int f[3], int branch, int which) {
        static const int pairs[3][4] = {
            {0, 2, 0, 1}, {0, 1, 0, 2}, {1, 2, 0, 1}};
        int a = f[pairs[which][0]], b = f[pairs[which][1]];
        // reuse `branch` node as the inner parent
        Node& inner = nodes[branch];
        inner.left = a;
        inner.right = b;
        nodes[a].parent = branch;
        nodes[b].parent = branch;
        refresh_internal(branch);
        // outer = v over (slot[p2], slot[p3])
        const int s2 = pairs[which][2], s3 = pairs[which][3];
        int left = (s2 == pairs[which][0]) ? branch : f[s2];
        int right = (s3 == pairs[which][0]) ? branch : f[s3];
        Node& outer = nodes[v];
        outer.left = left;
        outer.right = right;
        nodes[left].parent = v;
        nodes[right].parent = v;
        refresh_internal(v);
    }

    // ---- slicing -------------------------------------------------------
    void do_slice(int bond) {
        // remove bond from live network
        for (int t = 0; t < live.n_tensors; t++) {
            auto& tb = live.tensor_bonds[t];
            auto it = std::find(tb.begin(), tb.end(), bond);
            if (it != tb.end()) tb.erase(it);
        }
        live.sliced[bond] = 1;
        sliced_bonds.push_back(bond);
        refresh_affected(bond);
    }

    void undo_slice(int bond) {
        for (int t = 0; t < net->n_tensors; t++) {
            const auto& orig = net->tensor_bonds[t];
            if (std::find(orig.begin(), orig.end(), bond) != orig.end())
                live.tensor_bonds[t].push_back(bond);
        }
        live.sliced[bond] = 0;
        sliced_bonds.erase(
            std::find(sliced_bonds.begin(), sliced_bonds.end(), bond));
        refresh_affected(bond);
    }

    void refresh_affected(int bond) {
        // refresh leaves touching the bond and all their ancestors,
        // bottom-up (postorder subset)
        std::vector<uint8_t> marked(nodes.size(), 0);
        for (int t = 0; t < net->n_tensors; t++) {
            const auto& orig = net->tensor_bonds[t];
            if (std::find(orig.begin(), orig.end(), bond) == orig.end())
                continue;
            int v = t;
            while (v >= 0 && !marked[v]) {
                marked[v] = 1;
                v = nodes[v].parent;
            }
        }
        // bottom-up order: reverse preorder works (children after parents
        // in preorder -> process reversed)
        std::vector<int> order;
        preorder(order);
        for (auto it = order.rbegin(); it != order.rend(); ++it) {
            if (!marked[*it]) continue;
            if (nodes[*it].leaf()) refresh_leaf(*it);
            else refresh_internal(*it);
        }
    }

    // candidate bonds: boundaries of max-sc nodes, excluding open bonds
    void slice_candidates(std::vector<int>& out) const {
        out.clear();
        double tcv, scv, mcv;
        complexity(tcv, scv, mcv);
        std::vector<uint8_t> seen(live.n_bonds, 0);
        std::vector<int> order;
        preorder(order);
        for (int v : order) {
            if (nodes[v].sc != scv) continue;
            for (int b : nodes[v].bonds) {
                if (!seen[b] && live.degree[b] > 1 && !live.sliced[b]) {
                    seen[b] = 1;
                    out.push_back(b);
                }
            }
        }
    }

    // incremental what-if slicing (mirrors whatif_slice in tree.py)
    void whatif_slice(int bond, double& tc, double& sc, double& mc) const {
        double d = live.log2dim[bond];
        std::vector<double> tcs, mcs;
        double scmax = -1e300;
        std::vector<int> order;
        preorder(order);
        for (int v : order) {
            const Node& nd = nodes[v];
            if (nd.has_bond(bond)) {
                bool in_bound = std::binary_search(nd.bonds.begin(), nd.bonds.end(), bond);
                double s = in_bound ? nd.sc - d : nd.sc;
                if (nd.leaf()) {
                    scmax = std::max(scmax, s);
                    continue;
                }
                double t = nd.tc - d;
                bool in_contract = std::binary_search(
                    nd.contract.begin(), nd.contract.end(), bond);
                if (in_contract && nd.contract.size() == 1) t -= 1.0;
                const Node& L = nodes[nd.left];
                const Node& R = nodes[nd.right];
                double sl = L.has_bond(bond) ? L.sc - d : L.sc;
                double sr = R.has_bond(bond) ? R.sc - d : R.sc;
                double scs[3] = {sl, sr, s};
                tcs.push_back(t);
                scmax = std::max(scmax, s);
                mcs.push_back(log2sumexp2(scs, 3));
            } else {
                scmax = std::max(scmax, nd.sc);
                if (!nd.leaf()) {
                    tcs.push_back(nd.tc);
                    mcs.push_back(nd.mc);
                }
            }
        }
        tc = log2sumexp2(tcs.data(), (int)tcs.size()) * LOG10_2;
        sc = scmax;
        mc = log2sumexp2(mcs.data(), (int)mcs.size()) * LOG10_2;
    }

    // export order (BFS over min contained tensor id, like to_order_bfs)
    void export_order(std::vector<int>& out) const {
        std::vector<int> mins(nodes.size(), 1 << 30);
        std::vector<int> order;
        preorder(order);
        for (auto it = order.rbegin(); it != order.rend(); ++it) {
            const Node& nd = nodes[*it];
            mins[*it] = nd.leaf() ? nd.leaf_id
                                  : std::min(mins[nd.left], mins[nd.right]);
        }
        out.clear();
        std::vector<int> queue{root};
        size_t head = 0;
        std::vector<std::pair<int, int>> pairs;
        while (head < queue.size()) {
            int v = queue[head++];
            if (nodes[v].leaf()) continue;
            queue.push_back(nodes[v].left);
            queue.push_back(nodes[v].right);
            int a = mins[nodes[v].left], b = mins[nodes[v].right];
            pairs.emplace_back(std::min(a, b), std::max(a, b));
        }
        for (auto it = pairs.rbegin(); it != pairs.rend(); ++it) {
            out.push_back(it->first);
            out.push_back(it->second);
        }
    }
};

struct TrialResult {
    double score = 1e300, tc = 0, sc = 0, mc = 0;
    std::vector<int> order;        // flattened pairs
    std::vector<int> sliced;
};

void run_trial(const Network& net, const int* init_order, int iters,
               const double* betas, int n_betas, double sc_target,
               double alpha, int slicing_repeat, uint64_t seed,
               int objective, const RoofParams& rp, TrialResult& best) {
    Tree tree;
    tree.init(net);
    tree.build(init_order, net.n_tensors - 1);
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    Node s1, s2;

    auto scored = [&](double& tc, double& sc, double& mc) {
        tree.complexity(tc, sc, mc);
        if (objective == 1) {
            // log10(seconds x 2^slices) + the legacy sc-budget penalty so
            // over-budget trees still feel slicing pressure; per-step
            // overhead amortized by the slice width the PEAK live
            // set allows (aggregate mc over-counts freed buffers)
            double r = std::log10(
                    tree.roofline(rp)
                    + width_overhead(tree.max_mc(), net.n_tensors - 1, rp))
                + tree.sliced_bonds.size() * LOG10_2
                + 2.0 * LOG10_2 * std::max(0.0, sc - sc_target);
            return r;
        }
        return score_fn(tc, sc, mc, sc_target, alpha);
    };

    auto snapshot_best = [&](double sco, double tc, double sc, double mc) {
        best.score = sco;
        best.tc = tc;
        best.sc = sc;
        best.mc = mc;
        tree.export_order(best.order);
        best.sliced = tree.sliced_bonds;
    };

    auto sweep = [&](double beta) {
        std::vector<int> stack{tree.root};
        while (!stack.empty()) {
            int v = stack.back();
            stack.pop_back();
            if (tree.nodes[v].leaf()) continue;
            int f[3], branch;
            if (tree.local_frontier(v, f, branch)) {
                int cur = tree.current_order3(v, f, branch);
                double tc0, sc0, mc0, tc1, sc1, mc1;
                double roof0 = 0, roof1 = 0;
                tree.whatif_order3(f, cur, tc0, sc0, mc0, s1, s2,
                                   &rp, objective == 1 ? &roof0 : nullptr);
                double ref = objective == 1
                    ? std::log10(roof0)
                      + 2.0 * LOG10_2 * std::max(0.0, sc0 - sc_target)
                    : score_fn(tc0, sc0, mc0, sc_target, alpha);
                // pick one of the two alternatives at random
                int alts[2], na = 0;
                for (int w = 0; w < 3; w++)
                    if (w != cur) alts[na++] = w;
                int cand = alts[rng() & 1];
                tree.whatif_order3(f, cand, tc1, sc1, mc1, s1, s2,
                                   &rp, objective == 1 ? &roof1 : nullptr);
                double cs = objective == 1
                    ? std::log10(roof1)
                      + 2.0 * LOG10_2 * std::max(0.0, sc1 - sc_target)
                    : score_fn(tc1, sc1, mc1, sc_target, alpha);
                double delta = cs - ref;
                if (delta <= 0 || uni(rng) < std::exp(-beta * delta))
                    tree.apply_order3(v, f, branch, cand);
            }
            stack.push_back(tree.nodes[v].left);
            stack.push_back(tree.nodes[v].right);
        }
    };

    double tc, sc, mc;
    double sco = scored(tc, sc, mc);
    snapshot_best(sco, tc, sc, mc);

    for (int bi = 0; bi < n_betas; bi++) {
        for (int it = 0; it < iters; it++) {
            sweep(betas[bi]);
            sco = scored(tc, sc, mc);
            if (sco < best.score) snapshot_best(sco, tc, sc, mc);
        }
    }

    // rebuild best tree for the slicing loop
    tree.init(net);
    tree.build(best.order.data(), net.n_tensors - 1);
    double opt_sc;
    {
        double t_, m_;
        tree.complexity(t_, opt_sc, m_);
    }
    int loop = 0;
    double best_sc = best.sc;
    while (loop < slicing_repeat * (opt_sc - sc_target) || best_sc > sc_target) {
        double cur_tc, cur_sc, cur_mc;
        tree.complexity(cur_tc, cur_sc, cur_mc);
        if (cur_sc > sc_target) {
            std::vector<int> cands;
            tree.slice_candidates(cands);
            if (cands.empty()) break;
            int pick = cands[0];
            double bestw = 1e300;
            for (int b : cands) {
                double w;
                if (objective == 1) {
                    tree.do_slice(b);
                    double wt, ws, wm;
                    tree.complexity(wt, ws, wm);
                    w = std::log10(
                            tree.roofline(rp)
                            + width_overhead(tree.max_mc(),
                                             net.n_tensors - 1, rp))
                        + tree.sliced_bonds.size() * LOG10_2
                        + 2.0 * LOG10_2 * std::max(0.0, ws - sc_target);
                    tree.undo_slice(b);
                } else {
                    double wt, ws, wm;
                    tree.whatif_slice(b, wt, ws, wm);
                    w = score_fn(wt, ws, wm, sc_target, alpha);
                }
                if (w < bestw) {
                    bestw = w;
                    pick = b;
                }
            }
            tree.do_slice(pick);
        } else if (!tree.sliced_bonds.empty()) {
            int b = tree.sliced_bonds[rng() % tree.sliced_bonds.size()];
            tree.undo_slice(b);
        }
        sco = scored(tc, sc, mc);
        snapshot_best(sco, tc, sc, mc);
        best_sc = sc;
        int start = std::max(0, n_betas - 10);
        for (int bi = start; bi < n_betas; bi++) {
            for (int it = 0; it < iters; it++) {
                sweep(betas[bi]);
                sco = scored(tc, sc, mc);
                if (sco < best.score) {
                    snapshot_best(sco, tc, sc, mc);
                    best_sc = sc;
                }
            }
        }
        loop++;
        // continue from the best configuration seen
        if (tree.sliced_bonds != best.sliced) {
            tree.init(net);
            for (int b : best.sliced) {
                // apply slice directly (no refresh needed pre-build)
                for (int t = 0; t < tree.live.n_tensors; t++) {
                    auto& tb = tree.live.tensor_bonds[t];
                    auto it2 = std::find(tb.begin(), tb.end(), b);
                    if (it2 != tb.end()) tb.erase(it2);
                }
                tree.live.sliced[b] = 1;
                tree.sliced_bonds.push_back(b);
            }
            tree.build(best.order.data(), net.n_tensors - 1);
        }
    }
}

}  // namespace

extern "C" {

// returns number of sliced bonds, or -1 on error.
int sa_find_order(
    int n_tensors,
    const int* bond_offsets,   // n_tensors+1 CSR offsets
    const int* bond_ids,       // CSR bond ids
    int n_bonds,
    const double* bond_log2dim,
    const unsigned char* is_final,
    double log2_max_bitstring,
    int trials,
    const int* init_orders,    // trials x (n_tensors-1) x 2
    int iters,
    int n_betas,
    const double* betas,
    double sc_target,
    double alpha,
    int slicing_repeat,
    uint64_t seed,
    int n_threads,
    int* out_order,            // (n_tensors-1) x 2
    int* out_sliced,           // capacity n_bonds
    double* out_stats,         // [tc, sc, mc, score]
    int objective,             // 0 = legacy score, 1 = device roofline
    double roof_muladds_per_s,
    double roof_bytes_per_s,
    double roof_step_ov_w1_s,
    double roof_hbm_budget_bytes,
    double roof_k_full,
    double roof_step_ov_s)
{
    RoofParams rp;
    if (roof_muladds_per_s > 0) rp.muladds_per_s = roof_muladds_per_s;
    if (roof_bytes_per_s > 0) rp.bytes_per_s = roof_bytes_per_s;
    if (roof_step_ov_w1_s > 0) rp.step_ov_w1 = roof_step_ov_w1_s;
    if (roof_hbm_budget_bytes > 0) rp.hbm_budget = roof_hbm_budget_bytes;
    if (roof_k_full > 0) rp.k_full = roof_k_full;
    if (roof_step_ov_s >= 0) rp.step_ov = roof_step_ov_s;
    if (n_tensors < 2) return -1;
    Network net;
    net.n_tensors = n_tensors;
    net.n_bonds = n_bonds;
    net.tensor_bonds.resize(n_tensors);
    for (int t = 0; t < n_tensors; t++)
        net.tensor_bonds[t].assign(bond_ids + bond_offsets[t],
                                   bond_ids + bond_offsets[t + 1]);
    net.log2dim.assign(bond_log2dim, bond_log2dim + n_bonds);
    net.degree.assign(n_bonds, 0);
    for (int t = 0; t < n_tensors; t++)
        for (int b : net.tensor_bonds[t]) net.degree[b]++;
    net.is_final.assign(is_final, is_final + n_tensors);
    net.sliced.assign(n_bonds, 0);
    net.log2_max_bitstring = log2_max_bitstring;

    std::vector<TrialResult> results(trials);
    int pairs = n_tensors - 1;
    if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
    n_threads = std::max(1, std::min(n_threads, trials));
    std::vector<std::thread> pool;
    std::vector<int> next_trial{0};
    for (int w = 0; w < n_threads; w++) {
        pool.emplace_back([&, w]() {
            for (int tr = w; tr < trials; tr += n_threads) {
                run_trial(net, init_orders + tr * pairs * 2, iters, betas,
                          n_betas, sc_target, alpha, slicing_repeat,
                          seed + 7919ull * (uint64_t)tr, objective, rp,
                          results[tr]);
            }
        });
    }
    for (auto& th : pool) th.join();

    // rank: mode 0 by total flops (tc + #slices*log10 2), mode 1 by the
    // roofline objective the trials optimized (stored in .score)
    int bi = 0;
    double bv = 1e300;
    for (int tr = 0; tr < trials; tr++) {
        double v = objective == 1
            ? results[tr].score
            : results[tr].tc + results[tr].sliced.size() * LOG10_2;
        if (v < bv) {
            bv = v;
            bi = tr;
        }
    }
    const TrialResult& b = results[bi];
    std::memcpy(out_order, b.order.data(), sizeof(int) * pairs * 2);
    for (size_t s = 0; s < b.sliced.size(); s++) out_sliced[s] = b.sliced[s];
    out_stats[0] = b.tc;
    out_stats[1] = b.sc;
    out_stats[2] = b.mc;
    out_stats[3] = b.score;
    return (int)b.sliced.size();
}

}  // extern "C"
