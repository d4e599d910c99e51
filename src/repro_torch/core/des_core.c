/* Native event core for the vectorized DES engine (repro_torch.core.des).
 *
 * One call simulates a whole stacked scenario batch: plans arrive as
 * (S, B, H) compacted hop tables (NO_HOP squeezed out, n_hops per query)
 * and the core runs the exact per-node-FIFO discrete-event simulation for
 * every scenario without returning to Python between events.
 *
 * Exactness contract (vs repro_torch.core.coordination.simulate_reference):
 * the event set is ordered by the unique key (time, qid); a binary heap
 * pops the global minimum of that key, so the pop sequence -- and hence
 * every float64 max/add -- is identical to Python's heapq loop.  Finish
 * events carry no side effects besides scheduling the successor op, so
 * they are folded into the last service hop (same times, fewer events).
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    double t;
    int64_t q;
} ev_t;

static inline int ev_lt(ev_t a, ev_t b) {
    return a.t < b.t || (a.t == b.t && a.q < b.q);
}

static void heap_push(ev_t *h, int64_t *n, ev_t e) {
    int64_t i = (*n)++;
    h[i] = e;
    while (i > 0) {
        int64_t p = (i - 1) >> 1;
        if (!ev_lt(h[i], h[p]))
            break;
        ev_t tmp = h[p];
        h[p] = h[i];
        h[i] = tmp;
        i = p;
    }
}

static ev_t heap_pop(ev_t *h, int64_t *n) {
    ev_t top = h[0];
    h[0] = h[--(*n)];
    int64_t i = 0;
    for (;;) {
        int64_t l = 2 * i + 1, r = l + 1, m = i;
        if (l < *n && ev_lt(h[l], h[m]))
            m = l;
        if (r < *n && ev_lt(h[r], h[m]))
            m = r;
        if (m == i)
            break;
        ev_t tmp = h[m];
        h[m] = h[i];
        h[i] = tmp;
        i = m;
    }
    return top;
}

/* Simulate one scenario.  mode_closed == 0: open loop, issue times come
 * from `arrivals`.  mode_closed == 1: closed loop, client c plays ops
 * c, c+K, c+2K, ... back to back (think time between reply and reissue).
 */
static void sim_one(const int32_t *nodes, const float *service,
                    const int32_t *n_hops, const double *arrivals,
                    int64_t B, int64_t H, int64_t K, int64_t N,
                    double link, double think, int32_t mode_closed,
                    double *node_free, int32_t *cur_hop, ev_t *heap,
                    double *finish, double *issue, double *hop_done) {
    int64_t hn = 0;
    (void)N;
    if (mode_closed) {
        int64_t KK = K < B ? K : B;
        for (int64_t c = 0; c < KK; c++) {
            cur_hop[c] = 0;
            issue[c] = 0.0;
            ev_t e = {link, c};
            heap_push(heap, &hn, e);
        }
    } else {
        for (int64_t q = 0; q < B; q++) {
            cur_hop[q] = 0;
            issue[q] = arrivals[q];
            ev_t e = {arrivals[q] + link, q};
            heap_push(heap, &hn, e);
        }
    }
    while (hn > 0) {
        ev_t e = heap_pop(heap, &hn);
        int64_t q = e.q;
        int32_t h = cur_hop[q];
        int32_t nh = n_hops[q];
        double fin_t;
        if (h < nh) {
            int32_t n = nodes[q * H + h];
            double s = (double)service[q * H + h];
            double nf = node_free[n];
            double start = e.t > nf ? e.t : nf;
            double done = start + s;
            node_free[n] = done;
            if (hop_done)
                hop_done[q * H + h] = done;
            if (h + 1 < nh) {
                cur_hop[q] = h + 1;
                ev_t nxt = {done + link, q};
                heap_push(heap, &hn, nxt);
                continue;
            }
            fin_t = done + link;
        } else {
            /* all-NO_HOP plan: the arrival event itself is the reply */
            fin_t = e.t;
        }
        finish[q] = fin_t;
        if (mode_closed) {
            int64_t nq = q + K;
            if (nq < B) {
                cur_hop[nq] = 0;
                issue[nq] = fin_t + think;
                ev_t nxt = {fin_t + think + link, nq};
                heap_push(heap, &hn, nxt);
            }
        }
    }
}

/* Entry point: simulate S stacked scenarios in one call.
 *
 * nodes    (S, B, H) int32, compacted (live hops first, NO_HOP pad after)
 * service  (S, B, H) float32 per-visit service ticks
 * n_hops   (S, B)    int32 live hop count per query
 * arrivals (S, B)    float64 open-loop issue times (NULL when closed loop)
 * scratch_node_free (N,)        float64
 * scratch_hop       (B,)        int32
 * scratch_heap      (B+1, 2)    float64 (reinterpreted as ev_t)
 * finish, issue     (S, B)      float64 outputs (caller-zeroed)
 * hop_done          (S, B, H)   float64 per-hop completion times in the
 *                               compacted hop order (caller-zeroed), or
 *                               NULL to skip recording — the event loop
 *                               computes `done` either way, this merely
 *                               stops discarding it (exact interior
 *                               timestamps for the trace exporter)
 */
void des_simulate_batch(const int32_t *nodes, const float *service,
                        const int32_t *n_hops, const double *arrivals,
                        int64_t S, int64_t B, int64_t H, int64_t K, int64_t N,
                        double link, double think, int32_t mode_closed,
                        double *scratch_node_free, int32_t *scratch_hop,
                        double *scratch_heap, double *finish, double *issue,
                        double *hop_done) {
    for (int64_t s = 0; s < S; s++) {
        memset(scratch_node_free, 0, (size_t)N * sizeof(double));
        sim_one(nodes + s * B * H, service + s * B * H, n_hops + s * B,
                arrivals ? arrivals + s * B : 0, B, H, K, N, link, think,
                mode_closed, scratch_node_free, scratch_hop,
                (ev_t *)scratch_heap, finish + s * B, issue + s * B,
                hop_done ? hop_done + s * B * H : 0);
    }
}

/* out[i] = powf(u[i], e) for i < n: the float32 power of the Pareto
 * service draw (coordination.ServiceModel).  The C library's powf gives
 * the bits of the reference's float32 `u ** e` on the CPU, where a float64
 * power rounded to float32 differs in about one draw in 1,700 (ROADMAP
 * F5). */
void des_powf(const float *u, float e, float *out, int64_t n) {
    for (int64_t i = 0; i < n; i++)
        out[i] = powf(u[i], e);
}

/* out[i] = sinf(x[i]), out[n + i] = cosf(x[i]) for i < n: the C library's
 * float32 sine and cosine, which XLA's CPU backend calls for jnp.sin /
 * jnp.cos (models.common.sinusoid_pos; torch's sin differs in about one
 * value in twenty, ROADMAP F16). */
void des_sincosf(const float *x, float *out, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        out[i] = sinf(x[i]);
        out[n + i] = cosf(x[i]);
    }
}
