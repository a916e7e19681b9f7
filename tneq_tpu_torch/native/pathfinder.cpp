// Contraction-path optimizer for einsum networks.
//
// Native replacement for the host-side path search the reference leaves to
// opt_einsum's Python 'greedy'/'auto' (compile-time hot for large circuits:
// the siamese network of an N-core QCTN has 2N+2*nqubits+nqubits operands —
// SURVEY.md flags the path search at qctn-build time as a hot spot).
//
// Algorithm: greedy pairwise contraction. At each step pick the feasible
// pair (sharing at least one contractible index; outer products deferred)
// that minimizes  size(result) - size(a) - size(b),  tie-broken by fewer
// flops — the same objective class as opt_einsum's greedy, in C++ with
// bitset index arithmetic. Emits an opt_einsum-style path: a sequence of
// (i, j) position pairs into the shrinking operand list.
//
// C ABI (ctypes):
//   int tneq_find_path(
//       int n_ops,
//       const int* op_offsets,   // n_ops+1 prefix offsets into op_symbols
//       const int* op_symbols,   // concatenated symbol ids per operand
//       const double* sym_sizes, // size per symbol id (n_syms)
//       int n_syms,
//       const int* out_symbols, int n_out,
//       int* path_out)           // 2*(n_ops-1) ints, (i, j) pairs
// Returns 0 on success.

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <vector>

namespace {

struct Operand {
    std::vector<uint64_t> mask;  // bitset over symbols
    double size;                 // product of symbol sizes
};

inline bool get_bit(const std::vector<uint64_t>& m, int s) {
    return (m[s >> 6] >> (s & 63)) & 1ull;
}
inline void set_bit(std::vector<uint64_t>& m, int s) {
    m[s >> 6] |= 1ull << (s & 63);
}

double mask_size(const std::vector<uint64_t>& m, const double* sym_sizes,
                 int n_syms) {
    double sz = 1.0;
    for (int s = 0; s < n_syms; ++s)
        if (get_bit(m, s)) sz *= sym_sizes[s];
    return sz;
}

}  // namespace

extern "C" int tneq_find_path(int n_ops, const int* op_offsets,
                              const int* op_symbols, const double* sym_sizes,
                              int n_syms, const int* out_symbols, int n_out,
                              int* path_out) {
    if (n_ops < 1 || n_syms < 1) return 1;

    // Incremental slot-based greedy: operands live in fixed slots with
    // per-operand SYMBOL LISTS and a symbol -> slots occupancy map kept up
    // to date across merges.  Candidate pairs are only slots sharing a
    // symbol, so each step costs O(sum of contact-list lengths) — ~O(n)
    // for bounded-degree tensor networks, O(n^2) overall (the previous
    // all-pairs rescan was O(n^4) and unusable beyond ~500 operands).
    std::vector<int> refcount(n_syms, 0);
    for (int i = 0; i < n_out; ++i) refcount[out_symbols[i]] += 1;

    struct Slot {
        std::vector<int> syms;  // sorted unique symbol ids
        double size = 1.0;
        bool live = false;
    };
    std::vector<Slot> slots;
    slots.reserve(2 * n_ops);
    std::vector<std::vector<int>> sym_slots(n_syms);  // lazy-deleted

    auto size_of = [&](const std::vector<int>& syms) {
        double sz = 1.0;
        for (int s : syms) sz *= sym_sizes[s];
        return sz;
    };

    for (int i = 0; i < n_ops; ++i) {
        Slot sl;
        for (int k = op_offsets[i]; k < op_offsets[i + 1]; ++k) {
            int s = op_symbols[k];
            if (s < 0 || s >= n_syms) return 2;
            sl.syms.push_back(s);
        }
        std::sort(sl.syms.begin(), sl.syms.end());
        sl.syms.erase(std::unique(sl.syms.begin(), sl.syms.end()),
                      sl.syms.end());
        for (int s : sl.syms) {
            refcount[s] += 1;
            sym_slots[s].push_back(i);
        }
        sl.size = size_of(sl.syms);
        sl.live = true;
        slots.push_back(std::move(sl));
    }

    // result symbols of contracting slots a, b: union minus fully-consumed
    auto result_syms = [&](const Slot& a, const Slot& b) {
        std::vector<int> uni;
        uni.reserve(a.syms.size() + b.syms.size());
        std::set_union(a.syms.begin(), a.syms.end(), b.syms.begin(),
                       b.syms.end(), std::back_inserter(uni));
        std::vector<int> kept;
        kept.reserve(uni.size());
        for (int s : uni) {
            int in_a = std::binary_search(a.syms.begin(), a.syms.end(), s);
            int in_b = std::binary_search(b.syms.begin(), b.syms.end(), s);
            if (refcount[s] - in_a - in_b > 0) kept.push_back(s);
        }
        return kept;
    };

    // position bookkeeping for the opt_einsum path format: `order` is the
    // current shrinking operand list as slot ids
    std::vector<int> order(n_ops);
    for (int i = 0; i < n_ops; ++i) order[i] = i;

    std::vector<int> stamp(2 * n_ops, -1);
    int step = 0;
    int n_live = n_ops;
    while (n_live > 1) {
        int best_a = -1, best_b = -1;
        double best_gain = 0.0, best_flops = 0.0;
        bool found = false;
        // enumerate sharing pairs via occupancy lists (lazy-clean dead)
        for (int ai = 0; ai < (int)slots.size(); ++ai) {
            if (!slots[ai].live) continue;
            for (int s : slots[ai].syms) {
                auto& occ = sym_slots[s];
                size_t w = 0;
                for (size_t r = 0; r < occ.size(); ++r) {
                    int b = occ[r];
                    if (!slots[b].live) continue;  // drop dead entries
                    occ[w++] = b;
                    if (b <= ai || stamp[b] == ai) continue;
                    stamp[b] = ai;
                    auto kept = result_syms(slots[ai], slots[b]);
                    double rsize = size_of(kept);
                    double gain =
                        rsize - slots[ai].size - slots[b].size;
                    std::vector<int> uni;
                    std::set_union(slots[ai].syms.begin(),
                                   slots[ai].syms.end(),
                                   slots[b].syms.begin(),
                                   slots[b].syms.end(),
                                   std::back_inserter(uni));
                    double flops = size_of(uni);
                    if (!found || gain < best_gain ||
                        (gain == best_gain && flops < best_flops)) {
                        found = true;
                        best_gain = gain;
                        best_flops = flops;
                        best_a = ai;
                        best_b = b;
                    }
                }
                occ.resize(w);
            }
        }
        if (!found) {  // disconnected components: outer-product first two
            best_a = best_b = -1;
            for (int i = 0; i < (int)slots.size() && best_b < 0; ++i) {
                if (!slots[i].live) continue;
                if (best_a < 0) best_a = i;
                else best_b = i;
            }
        }

        // record positions in the current order list
        int pos_a = -1, pos_b = -1;
        for (int p2 = 0; p2 < (int)order.size(); ++p2) {
            if (order[p2] == best_a) pos_a = p2;
            else if (order[p2] == best_b) pos_b = p2;
        }
        if (pos_a < 0 || pos_b < 0) return 3;
        path_out[2 * step] = std::min(pos_a, pos_b);
        path_out[2 * step + 1] = std::max(pos_a, pos_b);
        ++step;

        // merge: build the new slot, update refcounts and occupancy
        Slot merged;
        merged.syms = result_syms(slots[best_a], slots[best_b]);
        merged.size = size_of(merged.syms);
        merged.live = true;
        for (int s : slots[best_a].syms) refcount[s] -= 1;
        for (int s : slots[best_b].syms) refcount[s] -= 1;
        slots[best_a].live = false;
        slots[best_b].live = false;
        int new_id = (int)slots.size();
        for (int s : merged.syms) {
            refcount[s] += 1;
            sym_slots[s].push_back(new_id);
        }
        if ((int)stamp.size() <= new_id) stamp.resize(new_id + n_ops, -1);
        slots.push_back(std::move(merged));

        order.erase(order.begin() + std::max(pos_a, pos_b));
        order.erase(order.begin() + std::min(pos_a, pos_b));
        order.push_back(new_id);
        n_live -= 1;
    }
    return 0;
}

// Optimal pairwise-contraction order by bitmask dynamic programming over
// operand subsets (Held-Karp style).  cost[S] = min over nonempty proper
// subsets L of S of cost[L] + cost[S\L] + flops(contract(L, S\L)).
// Exponential in n_ops — callers cap n_ops (<= ~16).  Emits the same
// opt_einsum-style (i, j) position-pair path as tneq_find_path.
extern "C" int tneq_find_path_dp(int n_ops, const int* op_offsets,
                                 const int* op_symbols, const double* sym_sizes,
                                 int n_syms, const int* out_symbols, int n_out,
                                 int* path_out) {
    if (n_ops < 1 || n_ops > 20 || n_syms < 1) return 1;
    const int words = (n_syms + 63) / 64;
    const uint32_t FULL = (n_ops == 32) ? 0xFFFFFFFFu
                                        : ((1u << n_ops) - 1u);

    std::vector<int> refcount(n_syms, 0);
    for (int i = 0; i < n_out; ++i) refcount[out_symbols[i]] += 1;
    std::vector<std::vector<uint64_t>> op_masks(n_ops,
                                                std::vector<uint64_t>(words, 0));
    for (int i = 0; i < n_ops; ++i) {
        for (int k = op_offsets[i]; k < op_offsets[i + 1]; ++k) {
            int s = op_symbols[k];
            if (s < 0 || s >= n_syms) return 2;
            if (!get_bit(op_masks[i], s)) refcount[s] += 1;
            set_bit(op_masks[i], s);
        }
    }

    const uint32_t n_sets = FULL + 1u;
    // per-subset: union of symbols, result (kept) symbols, best cost, split
    std::vector<std::vector<uint64_t>> uni(n_sets,
                                           std::vector<uint64_t>(words, 0));
    std::vector<std::vector<uint64_t>> res(n_sets,
                                           std::vector<uint64_t>(words, 0));
    std::vector<double> cost(n_sets, 1e300);
    std::vector<uint32_t> split(n_sets, 0);

    // kept symbols of subset S: used outside S (by other operands or output)
    auto compute_sets = [&](uint32_t S) {
        std::vector<uint64_t> u(words, 0);
        std::vector<int> inner(n_syms, 0);
        for (int i = 0; i < n_ops; ++i) {
            if (!(S >> i & 1)) continue;
            for (int w = 0; w < words; ++w) u[w] |= op_masks[i][w];
            for (int s = 0; s < n_syms; ++s)
                if (get_bit(op_masks[i], s)) inner[s] += 1;
        }
        uni[S] = u;
        std::vector<uint64_t> r(words, 0);
        for (int s = 0; s < n_syms; ++s) {
            if (!get_bit(u, s)) continue;
            if (refcount[s] - inner[s] > 0) set_bit(r, s);
        }
        res[S] = std::move(r);
    };

    for (uint32_t S = 1; S <= FULL; ++S) {
        compute_sets(S);
        if (!(S & (S - 1))) {  // singleton
            cost[S] = 0.0;
            continue;
        }
        // iterate proper submasks
        for (uint32_t L = (S - 1) & S; L; L = (L - 1) & S) {
            uint32_t R = S & ~L;
            if (L < R) continue;  // each split once
            if (cost[L] >= 1e300 || cost[R] >= 1e300) continue;
            // cost of this pairwise step: product over the union of the
            // two subtrees' OPEN (result) index sets — interior indices
            // were contracted within the subtrees already
            std::vector<uint64_t> ru(words);
            for (int w = 0; w < words; ++w)
                ru[w] = res[L][w] | res[R][w];
            double flops = mask_size(ru, sym_sizes, n_syms);
            double c = cost[L] + cost[R] + flops;
            if (c < cost[S]) {
                cost[S] = c;
                split[S] = L;
            }
        }
    }

    // reconstruct: post-order emit of (i, j) position pairs in a simulated
    // shrinking operand list (contracted result appended at the end)
    std::vector<std::pair<uint32_t, uint32_t>> merges;
    // DFS: children before parent
    {
        std::vector<uint32_t> visit = {FULL};
        std::vector<uint32_t> post;
        while (!visit.empty()) {
            uint32_t S = visit.back();
            visit.pop_back();
            post.push_back(S);
            if (S & (S - 1)) {  // not singleton
                visit.push_back(split[S]);
                visit.push_back(S & ~split[S]);
            }
        }
        for (auto it = post.rbegin(); it != post.rend(); ++it)
            if (*it & (*it - 1)) merges.push_back({split[*it], *it & ~split[*it]});
    }
    // simulate the operand list as subsets
    std::vector<uint32_t> live;
    for (int i = 0; i < n_ops; ++i) live.push_back(1u << i);
    int step = 0;
    for (auto& m : merges) {
        int i_pos = -1, j_pos = -1;
        for (int p = 0; p < (int)live.size(); ++p) {
            if (live[p] == m.first) i_pos = p;
            else if (live[p] == m.second) j_pos = p;
        }
        if (i_pos < 0 || j_pos < 0) return 3;
        int a = std::min(i_pos, j_pos), b = std::max(i_pos, j_pos);
        path_out[2 * step] = a;
        path_out[2 * step + 1] = b;
        ++step;
        uint32_t merged = m.first | m.second;
        live.erase(live.begin() + b);
        live.erase(live.begin() + a);
        live.push_back(merged);
    }
    return 0;
}

// Batched variant: amortizes ctypes overhead when scoring many candidate
// networks (genetic search cost model).  Returns total estimated flops of
// the greedy path per network.
extern "C" int tneq_path_cost(int n_ops, const int* op_offsets,
                              const int* op_symbols, const double* sym_sizes,
                              int n_syms, const int* out_symbols, int n_out,
                              double* cost_out) {
    std::vector<int> path(2 * std::max(1, n_ops - 1));
    int rc = tneq_find_path(n_ops, op_offsets, op_symbols, sym_sizes, n_syms,
                            out_symbols, n_out, path.data());
    if (rc != 0) return rc;
    // replay to accumulate flops
    const int words = (n_syms + 63) / 64;
    std::vector<int> refcount(n_syms, 0);
    std::vector<uint64_t> out_mask(words, 0);
    for (int i = 0; i < n_out; ++i) {
        set_bit(out_mask, out_symbols[i]);
        refcount[out_symbols[i]] += 1;
    }
    std::vector<Operand> ops;
    for (int i = 0; i < n_ops; ++i) {
        Operand op;
        op.mask.assign(words, 0);
        for (int k = op_offsets[i]; k < op_offsets[i + 1]; ++k) {
            int s = op_symbols[k];
            if (!get_bit(op.mask, s)) refcount[s] += 1;
            set_bit(op.mask, s);
        }
        op.size = mask_size(op.mask, sym_sizes, n_syms);
        ops.push_back(std::move(op));
    }
    double total = 0.0;
    for (int st = 0; st + 1 < n_ops; ++st) {
        int i = path[2 * st], j = path[2 * st + 1];
        Operand& a = ops[i];
        Operand& b = ops[j];
        std::vector<uint64_t> u(words);
        for (int w = 0; w < words; ++w) u[w] = a.mask[w] | b.mask[w];
        total += mask_size(u, sym_sizes, n_syms);
        std::vector<uint64_t> r(words, 0);
        for (int s = 0; s < n_syms; ++s) {
            if (!get_bit(u, s)) continue;
            int users = refcount[s];
            int in_a = get_bit(a.mask, s), in_b = get_bit(b.mask, s);
            if (users - in_a - in_b > 0) set_bit(r, s);
        }
        for (int s = 0; s < n_syms; ++s) {
            if (get_bit(a.mask, s)) refcount[s] -= 1;
            if (get_bit(b.mask, s)) refcount[s] -= 1;
            if (get_bit(r, s)) refcount[s] += 1;
        }
        Operand merged;
        merged.mask = std::move(r);
        merged.size = mask_size(merged.mask, sym_sizes, n_syms);
        ops.erase(ops.begin() + j);
        ops.erase(ops.begin() + i);
        ops.push_back(std::move(merged));
    }
    *cost_out = total;
    return 0;
}
