// Exact hypervolume, native kernel.
//
// Contract parity with the reference's single native component
// (deap/tools/_hypervolume/hv.cpp: `hv.hypervolume(pointset, ref)`, backed by
// fpli_hv in _hv.c): exact volume, implicit minimization, points that do not
// strictly dominate the reference are discarded by the caller.
//
// The algorithm here is WFG (While, Bradstreet & Barone, "A Fast Way of
// Calculating Exact Hypervolumes", IEEE TEC 2012) — exclusive-hypervolume
// recursion over a worst-first sorted front with limit-set reduction — written
// from the published description.  It is a different exact algorithm family
// than the reference's FPL dimension sweep, chosen because it degrades
// gracefully to the fast 2-D staircase base case and needs no intrusive
// linked-list/AVL machinery.
//
// Exposed C ABI (consumed via ctypes from deap_tpu_torch/native/hv.py):
//   double deap_tpu_hv(const double* pts, long n, long d, const double* ref);
// `pts` is row-major (n, d); all points must be < ref componentwise.

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

struct Front {
    // Row-major point storage reused across recursion levels to avoid
    // per-call allocation: each level owns a scratch Front from a pool.
    std::vector<double> data;
    long n = 0;
    long d = 0;

    double* row(long i) { return data.data() + i * d; }
    const double* row(long i) const { return data.data() + i * d; }
    void reserve(long n_, long d_) {
        d = d_;
        data.resize(static_cast<size_t>(n_) * d_);
    }
};

// 2-D base case: staircase sweep, O(n log n).
double hv2d(Front& f, const double* ref) {
    struct P { double x, y; };
    std::vector<P> pts(f.n);
    for (long i = 0; i < f.n; ++i) pts[i] = {f.row(i)[0], f.row(i)[1]};
    std::sort(pts.begin(), pts.end(),
              [](const P& a, const P& b) { return a.x < b.x; });
    double total = 0.0, ymin = ref[1];
    for (const P& p : pts) {
        if (p.y < ymin) {
            total += (ref[0] - p.x) * (ymin - p.y);
            ymin = p.y;
        }
    }
    return total;
}

// Keep only non-dominated points of f (minimization), in place.
void nds(Front& f) {
    long keep = 0;
    for (long i = 0; i < f.n; ++i) {
        const double* pi = f.row(i);
        bool dominated = false;
        for (long j = 0; j < keep && !dominated; ++j) {
            const double* pj = f.row(j);
            bool all_le = true, any_lt = false;
            for (long k = 0; k < f.d; ++k) {
                if (pj[k] > pi[k]) { all_le = false; break; }
                if (pj[k] < pi[k]) any_lt = true;
            }
            dominated = all_le && any_lt;
        }
        if (dominated) continue;
        // pi survives; evict earlier kept points it dominates.
        long w = 0;
        for (long j = 0; j < keep; ++j) {
            const double* pj = f.row(j);
            bool all_le = true, any_lt = false;
            for (long k = 0; k < f.d; ++k) {
                if (pi[k] > pj[k]) { all_le = false; break; }
                if (pi[k] < pj[k]) any_lt = true;
            }
            if (!(all_le && any_lt)) {
                if (w != j) std::memcpy(f.row(w), pj, sizeof(double) * f.d);
                ++w;
            }
        }
        if (w != i) std::memcpy(f.row(w), pi, sizeof(double) * f.d);
        keep = w + 1;
    }
    f.n = keep;
}

struct WFG {
    const double* ref;
    long d;
    // One scratch front per recursion depth (depth <= n).  Pre-sized before
    // run() so recursion never reallocates the vector — outer frames hold
    // references into it.
    std::vector<Front> pool;

    double run(Front& f, size_t depth) {
        if (f.n == 0) return 0.0;
        if (f.d == 1) {
            double m = f.row(0)[0];
            for (long i = 1; i < f.n; ++i) m = std::min(m, f.row(i)[0]);
            return ref[0] - m;
        }
        if (f.d == 2) return hv2d(f, ref);

        // Sort worst-first on the last objective: limit sets shrink fastest.
        std::vector<long> order(f.n);
        for (long i = 0; i < f.n; ++i) order[i] = i;
        std::sort(order.begin(), order.end(), [&](long a, long b) {
            return f.row(a)[f.d - 1] > f.row(b)[f.d - 1];
        });
        Front sorted;
        sorted.reserve(f.n, f.d);
        sorted.n = f.n;
        for (long i = 0; i < f.n; ++i)
            std::memcpy(sorted.row(i), f.row(order[i]), sizeof(double) * f.d);

        double total = 0.0;
        for (long k = 0; k < sorted.n; ++k) {
            const double* p = sorted.row(k);
            double inclusive = 1.0;
            for (long j = 0; j < f.d; ++j) inclusive *= ref[j] - p[j];
            long rest = sorted.n - k - 1;
            if (rest > 0) {
                Front& lim = pool[depth];
                lim.reserve(rest, f.d);
                lim.n = rest;
                for (long i = 0; i < rest; ++i) {
                    const double* q = sorted.row(k + 1 + i);
                    double* dst = lim.row(i);
                    for (long j = 0; j < f.d; ++j)
                        dst[j] = std::max(q[j], p[j]);
                }
                nds(lim);
                total += inclusive - run(lim, depth + 1);
            } else {
                total += inclusive;
            }
        }
        return total;
    }
};

}  // namespace

extern "C" double deap_tpu_hv(const double* pts, long n, long d,
                              const double* ref) {
    if (n <= 0 || d <= 0) return 0.0;
    Front f;
    f.reserve(n, d);
    f.n = n;
    std::memcpy(f.data.data(), pts, sizeof(double) * n * d);
    nds(f);
    WFG wfg;
    wfg.ref = ref;
    wfg.d = d;
    wfg.pool.resize(static_cast<size_t>(f.n) + 1);
    return wfg.run(f, 0);
}
