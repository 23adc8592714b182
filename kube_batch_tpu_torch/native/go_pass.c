/* The reference allocate loop's inner per-task pass — predicate every node
 * then score (LeastRequested + BalancedResourceAllocation) and argmax
 * (allocate.go:151-159, scheduler_helper.go:34-129, nodeorder.go:188-227) —
 * at compiled-native speed, single-threaded and chunked over a pool.
 *
 * Purpose: MEASURE the Go-loop denominator of testing/go_baseline.py on the
 * host that drives the card.  The Go loop runs this pass per task through a
 * 16-worker ParallelizeUntil; compiled C is the speed class of compiled Go,
 * so timing (a) the numpy vector pass, (b) this C pass single-threaded, and
 * (c) this C pass on a persistent thread pool with per-pass barriers (the
 * fork/join chunking workqueue.ParallelizeUntil pays per call) bounds what
 * the reference could achieve — testing/go_pass_bench.py reports all three.
 *
 * Semantics mirror go_baseline.go_loop_allocate's inner pass exactly:
 * epsilon-tolerant fit over all R dims, cpu/mem scoring with capacity
 * clamped to >= 1, first-max argmax.  Built by native/__init__.py with
 * -ffp-contract=off: an FMA-contracted multiply-add drifts by ULPs against
 * numpy and can flip argmax ties.
 */
#include <math.h>
#include <pthread.h>
#include <stdint.h>

typedef struct {
    const double *req, *idle, *alloc, *quanta;
    int64_t N, R;
} pass_args_t;

static void pass_range(const pass_args_t *a, int64_t lo, int64_t hi,
                       double *best_score, int64_t *best_idx) {
    const int64_t R = a->R;
    double best = -1e300;
    int64_t besti = -1;
    for (int64_t n = lo; n < hi; n++) {
        const double *idle = a->idle + n * R;
        int ok = 1;
        for (int64_t r = 0; r < R; r++) {
            if (a->req[r] > idle[r] + a->quanta[r]) { ok = 0; break; }
        }
        if (!ok) continue;
        const double *al = a->alloc + n * R;
        double cap_c = al[0] > 1.0 ? al[0] : 1.0;
        double cap_m = al[1] > 1.0 ? al[1] : 1.0;
        double used_c = al[0] - idle[0] + a->req[0];
        double used_m = al[1] - idle[1] + a->req[1];
        double fr_c = (cap_c - used_c) / cap_c;
        double fr_m = (cap_m - used_m) / cap_m;
        /* associate exactly like the numpy pass (lr and bal as separate
         * terms, then summed) — a different association drifts by ULPs and
         * can flip the argmax between near-tied nodes */
        double lr = (fr_c + fr_m) * 5.0;
        double bal = 10.0 - fabs(fr_c - fr_m) * 10.0;
        double s = lr + bal;
        if (s > best) { best = s; besti = n; }
    }
    *best_score = best;
    *best_idx = besti;
}

int64_t go_pass_single(const double *req, const double *idle,
                       const double *alloc, const double *quanta,
                       int64_t N, int64_t R) {
    pass_args_t a = {req, idle, alloc, quanta, N, R};
    double bs;
    int64_t bi;
    pass_range(&a, 0, N, &bs, &bi);
    return bi;
}

/* ---- persistent worker pool (ParallelizeUntil analog) ---------------- */

#define MAX_THREADS 64

static struct {
    pass_args_t args;
    double best_score[MAX_THREADS];
    int64_t best_idx[MAX_THREADS];
    int nthreads;
    int running;
    volatile int shutdown;
    pthread_barrier_t start, done;
    pthread_t threads[MAX_THREADS];
} P;

static void *pool_worker(void *argp) {
    intptr_t id = (intptr_t)argp;
    for (;;) {
        pthread_barrier_wait(&P.start);
        if (P.shutdown) return 0;
        int64_t per = (P.args.N + P.nthreads - 1) / P.nthreads;
        int64_t lo = id * per;
        int64_t hi = lo + per < P.args.N ? lo + per : P.args.N;
        if (lo > P.args.N) lo = P.args.N;
        pass_range(&P.args, lo, hi, &P.best_score[id], &P.best_idx[id]);
        pthread_barrier_wait(&P.done);
    }
}

static int pool_poisoned;

int go_pass_pool_init(int nthreads) {
    if (pool_poisoned || P.running || nthreads < 1 || nthreads > MAX_THREADS)
        return -1;
    P.nthreads = nthreads;
    P.shutdown = 0;
    pthread_barrier_init(&P.start, 0, (unsigned)nthreads + 1);
    pthread_barrier_init(&P.done, 0, (unsigned)nthreads + 1);
    for (intptr_t i = 0; i < nthreads; i++) {
        if (pthread_create(&P.threads[i], 0, pool_worker, (void *)i)) {
            /* Partial failure: the start barrier's waiter count is fixed at
             * nthreads+1, so the i parked workers cannot be released (one
             * more main-side wait would still be short of the count) and
             * re-initializing a barrier with waiters is UB.  Poison the
             * pool instead: the parked threads leak — pthread_create only
             * fails on thread exhaustion, an already-degenerate state —
             * and every future init refuses, so the barriers are never
             * touched again.  The Python caller raises. */
            pool_poisoned = 1;
            return -1;
        }
    }
    P.running = 1;
    return 0;
}

int64_t go_pass_pooled(const double *req, const double *idle,
                       const double *alloc, const double *quanta,
                       int64_t N, int64_t R) {
    if (!P.running) return -2;
    P.args = (pass_args_t){req, idle, alloc, quanta, N, R};
    pthread_barrier_wait(&P.start);  /* release the workers */
    pthread_barrier_wait(&P.done);   /* join the pass */
    double best = -1e300;
    int64_t besti = -1;
    for (int i = 0; i < P.nthreads; i++) {
        /* first-max across ordered chunks == global first-max */
        if (P.best_idx[i] >= 0 && P.best_score[i] > best) {
            best = P.best_score[i];
            besti = P.best_idx[i];
        }
    }
    return besti;
}

void go_pass_pool_shutdown(void) {
    if (!P.running) return;
    P.shutdown = 1;
    pthread_barrier_wait(&P.start);
    for (int i = 0; i < P.nthreads; i++) pthread_join(P.threads[i], 0);
    pthread_barrier_destroy(&P.start);
    pthread_barrier_destroy(&P.done);
    P.running = 0;
}

/* ---- the FULL sequential allocate loop at compiled speed -------------
 * go_baseline.go_loop_allocate's exact control flow (itself mirroring
 * allocate.go:95-200): walk tasks grouped by job, run the per-task pass,
 * place on the argmax node (mutating idle for the next task), commit the
 * gang iff its placement count reaches minAvailable else roll back in
 * reverse.  `use_pool` selects the 16-way chunked pass (the reference's
 * ParallelizeUntil shape; pool must be initialized) over the single-thread
 * pass.  Returns the number of placed tasks; assigned[t] = node or -1. */
int64_t go_loop_run(const double *task_req, const int64_t *task_job,
                    const int64_t *job_min, double *node_idle,
                    const double *node_alloc, const double *quanta,
                    int64_t T, int64_t N, int64_t R, int use_pool,
                    int64_t *assigned, int64_t *scratch /* [T] */) {
    int64_t placed_total = 0;
    for (int64_t t = 0; t < T; t++) assigned[t] = -1;
    int64_t i = 0;
    while (i < T) {
        int64_t j = task_job[i];
        int64_t lo = i;
        while (i < T && task_job[i] == j) i++;
        int64_t nplaced = 0;
        for (int64_t t = lo; t < i; t++) {
            const double *req = task_req + t * R;
            int64_t best;
            if (use_pool) {
                best = go_pass_pooled(req, node_idle, node_alloc, quanta, N, R);
            } else {
                best = go_pass_single(req, node_idle, node_alloc, quanta, N, R);
            }
            if (best < 0) continue;
            double *idle = node_idle + best * R;
            for (int64_t r = 0; r < R; r++) idle[r] -= req[r];
            scratch[nplaced] = t;
            assigned[t] = best;
            nplaced++;
        }
        if (nplaced >= job_min[j]) {
            placed_total += nplaced;
        } else {
            for (int64_t k = nplaced - 1; k >= 0; k--) {  /* reverse rollback */
                int64_t t = scratch[k];
                const double *req = task_req + t * R;
                double *idle = node_idle + assigned[t] * R;
                for (int64_t r = 0; r < R; r++) idle[r] += req[r];
                assigned[t] = -1;
            }
        }
    }
    return placed_total;
}
