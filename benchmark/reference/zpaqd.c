/* A ZPAQ level-2 block decoder, written for the benchmark's reference from
 * the ZPAQ format specification (Mahoney, "The ZPAQ Open Standard Format
 * for Highly Compressed Data", level 2, and its reference decoder libzpaq
 * 7.15): the block and segment layout, the ZPAQL machine that runs HCOMP
 * and PCOMP, the nine component kinds, the bit-history state table, and
 * the arithmetic decoder. It shares no code with the archiver under test.
 *
 * Tables are computed, not stored: squash() from its defining logistic
 * and stretch() from its logit, both held to libzpaq's published
 * checksums by zd_init(); the state table from the specification's
 * count rules.
 *
 * One call decodes one whole block: zd_block(). It touches no global
 * state after zd_init(), so threads decode blocks side by side.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef int32_t I32;

/* ---- tables ----------------------------------------------------------- */

static int squasht[4096];
static short stretcht[32768];
static int dt[1024];
static int dt2k[256];
static U8 ns[1024];      /* state*4: next on 0, next on 1, n0, n1 */
static U32 cminit_t[256];

static int squash(int x) {
    if (x > 2047) x = 2047;
    if (x < -2047) x = -2047;
    return squasht[x + 2048];
}

static int stretch(int p) { return stretcht[p]; }

/* the state table: a state stands for counts (n0, n1) of zeros and ones
 * seen in a context, with at most two states for a pair of counts */
static int num_states(int n0, int n1) {
    static const int bound[6] = {20, 48, 15, 8, 6, 5};
    if (n0 < n1) return num_states(n1, n0);
    if (n0 < 0 || n1 < 0 || n1 >= 6 || n0 > bound[n1]) return 0;
    return 1 + (n1 > 0 && n0 + n1 <= 17);
}

static void discount(int *n) {
    int x = *n;
    *n = (x >= 1) + (x >= 2) + (x >= 3) + (x >= 4) + (x >= 5) + (x >= 7)
         + (x >= 8);
}

static void next_state(int *n0, int *n1, int y) {
    if (*n0 < *n1) {
        next_state(n1, n0, 1 - y);
        return;
    }
    if (y) {
        ++*n1;
        discount(n0);
    } else {
        ++*n0;
        discount(n1);
    }
    while (!num_states(*n0, *n1)) {
        if (*n1 < 2) {
            --*n0;
        } else {
            *n0 = (*n0 * (*n1 - 1) + (*n1 / 2)) / *n1;
            --*n1;
        }
    }
}

static void make_states(void) {
    enum { N = 50 };
    static U8 t[N][N][2];
    int state = 0;
    memset(t, 0, sizeof t);
    for (int i = 0; i < N; ++i)
        for (int n1 = 0; n1 <= i; ++n1) {
            int n0 = i - n1, n = num_states(n0, n1);
            if (n) {
                t[n0][n1][0] = (U8)state;
                t[n0][n1][1] = (U8)(state + n - 1);
                state += n;
            }
        }
    memset(ns, 0, sizeof ns);
    for (int n0 = 0; n0 < N; ++n0)
        for (int n1 = 0; n1 < N; ++n1)
            for (int y = 0; y < num_states(n0, n1); ++y) {
                int s = t[n0][n1][y], s0 = n0, s1 = n1;
                next_state(&s0, &s1, 0);
                ns[s * 4 + 0] = t[s0][s1][0];
                s0 = n0;
                s1 = n1;
                next_state(&s0, &s1, 1);
                ns[s * 4 + 1] = t[s0][s1][1];
                ns[s * 4 + 2] = (U8)n0;
                ns[s * 4 + 3] = (U8)n1;
            }
    for (int s = 0; s < 256; ++s) {
        int n0 = ns[s * 4 + 2], n1 = ns[s * 4 + 3];
        cminit_t[s] = (U32)(((n1 * 2 + 1) << 22) / (n0 + n1 + 1));
    }
}

/* Builds the tables; returns 0 when squash() and stretch() match the
 * checksums libzpaq holds them to, else 1. Out: the two sums. */
int zd_init(U32 *sq, U32 *st) {
    for (int i = 0; i < 4096; ++i)
        squasht[i] = (int)(32768.0 / (1 + exp((i - 2048) * (-1.0 / 64))));
    for (int i = 0; i < 32768; ++i)
        stretcht[i] = (short)((int)(log((i + 0.5) / (32767.5 - i)) * 64
                                    + 0.5 + 100000) - 100000);
    dt2k[0] = 0;
    for (int i = 1; i < 256; ++i) dt2k[i] = 2048 / i;
    for (int i = 0; i < 1024; ++i) dt[i] = (1 << 17) / (i * 2 + 3) * 2;
    make_states();
    U32 a = 0, b = 0;
    for (int i = 32767; i >= 0; --i) b = b * 3 + (U32)stretch(i);
    for (int i = 4095; i >= 0; --i) a = a * 3 + (U32)squash(i - 2048);
    *sq = a;
    *st = b;
    return !(a == 2278286169u && b == 3887533746u);
}

/* the state table as computed, for the tests */
const U8 *zd_states(void) { return ns; }

/* ---- output buffer ---------------------------------------------------- */

typedef struct {
    U8 *p;
    size_t n, cap;
    int oom;
} Buf;

static void put(Buf *o, U8 c) {
    if (o->n == o->cap) {
        size_t cap = o->cap ? o->cap * 2 : (1 << 20);
        U8 *q = realloc(o->p, cap);
        if (!q) {
            o->oom = 1;
            return;
        }
        o->p = q;
        o->cap = cap;
    }
    o->p[o->n++] = c;
}

/* ---- ZPAQL ------------------------------------------------------------ */

typedef struct {
    U8 *code;          /* the program, then a zero guard */
    int len;
    U32 *h;
    U8 *m;
    U32 hmask, mmask;
    U32 r[256];
    U32 a, b, c, d;
    int f;
    Buf *out;          /* where OUT writes; NULL in HCOMP */
} VM;

static int vm_init(VM *z, const U8 *code, int len, int hbits, int mbits,
                   Buf *out) {
    memset(z, 0, sizeof *z);
    if (hbits > 30 || mbits > 30) return -1;
    z->code = calloc((size_t)len + 8, 1);
    z->h = calloc((size_t)1 << hbits, sizeof(U32));
    z->m = calloc((size_t)1 << mbits, 1);
    if (!z->code || !z->h || !z->m) return -1;
    memcpy(z->code, code, (size_t)len);
    z->len = len;
    z->hmask = (U32)(((size_t)1 << hbits) - 1);
    z->mmask = (U32)(((size_t)1 << mbits) - 1);
    z->out = out;
    return 0;
}

static void vm_free(VM *z) {
    free(z->code);
    free(z->h);
    free(z->m);
    z->code = NULL;
    z->h = NULL;
    z->m = NULL;
}

#define MB (z->m[z->b & z->mmask])
#define MC (z->m[z->c & z->mmask])
#define HD (z->h[z->d & z->hmask])

static void swap32(U32 *a, U32 *x) {
    U32 t = *a;
    *a = *x;
    *x = t;
}

static void swap8(U32 *a, U8 *x) {
    U8 t = *x;
    *x = (U8)*a;
    *a = (*a & ~255u) | t;
}

/* Runs the program once with A = input; 0 on HALT, -1 on an error. */
static int vm_run(VM *z, U32 input) {
    const U8 *code = z->code;
    int pc = 0;
    z->a = input;
    for (;;) {
        if (pc < 0 || pc >= z->len) return -1;
        int op = code[pc++];
        if (op >= 64 && op < 240) {
            U32 x;
            switch (op & 7) {
            case 0: x = z->a; break;
            case 1: x = z->b; break;
            case 2: x = z->c; break;
            case 3: x = z->d; break;
            case 4: x = MB; break;
            case 5: x = MC; break;
            case 6: x = HD; break;
            default: x = code[pc++]; break;
            }
            switch (op >> 3) {
            case 8: z->a = x; break;
            case 9: z->b = x; break;
            case 10: z->c = x; break;
            case 11: z->d = x; break;
            case 12: MB = (U8)x; break;
            case 13: MC = (U8)x; break;
            case 14: HD = x; break;
            case 15: return -1;
            case 16: z->a += x; break;
            case 17: z->a -= x; break;
            case 18: z->a *= x; break;
            case 19: z->a = x ? z->a / x : 0; break;
            case 20: z->a = x ? z->a % x : 0; break;
            case 21: z->a &= x; break;
            case 22: z->a &= ~x; break;
            case 23: z->a |= x; break;
            case 24: z->a ^= x; break;
            case 25: z->a <<= (x & 31); break;
            case 26: z->a >>= (x & 31); break;
            case 27: z->f = z->a == x; break;
            case 28: z->f = z->a < x; break;
            case 29: z->f = z->a > x; break;
            }
            continue;
        }
        switch (op) {
        case 1: ++z->a; break;
        case 2: --z->a; break;
        case 3: z->a = ~z->a; break;
        case 4: z->a = 0; break;
        case 7: z->a = z->r[code[pc++]]; break;
        case 8: swap32(&z->a, &z->b); break;
        case 9: ++z->b; break;
        case 10: --z->b; break;
        case 11: z->b = ~z->b; break;
        case 12: z->b = 0; break;
        case 15: z->b = z->r[code[pc++]]; break;
        case 16: swap32(&z->a, &z->c); break;
        case 17: ++z->c; break;
        case 18: --z->c; break;
        case 19: z->c = ~z->c; break;
        case 20: z->c = 0; break;
        case 23: z->c = z->r[code[pc++]]; break;
        case 24: swap32(&z->a, &z->d); break;
        case 25: ++z->d; break;
        case 26: --z->d; break;
        case 27: z->d = ~z->d; break;
        case 28: z->d = 0; break;
        case 31: z->d = z->r[code[pc++]]; break;
        case 32: swap8(&z->a, &MB); break;
        case 33: ++MB; break;
        case 34: --MB; break;
        case 35: MB = (U8)~MB; break;
        case 36: MB = 0; break;
        case 39:                        /* JT */
            if (z->f) pc += (I32)(int8_t)code[pc] + 1;
            else ++pc;
            break;
        case 40: swap8(&z->a, &MC); break;
        case 41: ++MC; break;
        case 42: --MC; break;
        case 43: MC = (U8)~MC; break;
        case 44: MC = 0; break;
        case 47:                        /* JF */
            if (!z->f) pc += (I32)(int8_t)code[pc] + 1;
            else ++pc;
            break;
        case 48: swap32(&z->a, &HD); break;
        case 49: ++HD; break;
        case 50: --HD; break;
        case 51: HD = ~HD; break;
        case 52: HD = 0; break;
        case 55: z->r[code[pc++]] = z->a; break;
        case 56: return 0;              /* HALT */
        case 57:                        /* OUT */
            if (z->out) put(z->out, (U8)z->a);
            break;
        case 59: z->a = (z->a + MB + 512) * 773; break;       /* HASH */
        case 60: HD = (HD + z->a + 512) * 773; break;         /* HASHD */
        case 63: pc += (I32)(int8_t)code[pc] + 1; break;      /* JMP */
        case 255:                       /* LJ */
            pc = code[pc] + 256 * code[pc + 1];
            break;
        default: return -1;
        }
    }
}

/* ---- the predictor ------------------------------------------------------ */

enum { CONS = 1, CM, ICM, MATCH, AVG, MIX2, MIX, ISSE, SSE };
static const int compsize[10] = {0, 2, 3, 2, 3, 4, 6, 6, 3, 5};

typedef struct {
    const U8 *cp;     /* the component's bytes in the header */
    U32 *cm;          /* CM, SSE counters; ICM probabilities; ISSE and MIX
                         weights; MATCH pointers */
    U32 cmmask;
    U8 *ht;           /* ICM, ISSE bit histories; MATCH history */
    U32 htmask;
    U16 *a16;         /* MIX2 weights */
    U32 limit, cxt, a, b, c;
} Comp;

typedef struct {
    int n;
    Comp comp[256];
    int p[256];
    U32 h[256];
    U32 c8, hmap4;
    VM z;
} Pred;

static U32 *cm_alloc(Comp *c, size_t n) {
    c->cm = calloc(n, sizeof(U32));
    c->cmmask = (U32)(n - 1);
    return c->cm;
}

static U8 *ht_alloc(Comp *c, size_t n) {
    c->ht = calloc(n, 1);
    c->htmask = (U32)(n - 1);
    return c->ht;
}

static void pred_free(Pred *pr) {
    for (int i = 0; i < pr->n; ++i) {
        free(pr->comp[i].cm);
        free(pr->comp[i].ht);
        free(pr->comp[i].a16);
    }
    vm_free(&pr->z);
}

static int clamp2k(int x) { return x < -2048 ? -2048 : x > 2047 ? 2047 : x; }

static int clamp512k(int x) {
    return x < -(1 << 19) ? -(1 << 19) : x > (1 << 19) - 1 ? (1 << 19) - 1
                                                           : x;
}

/* comps: the n components' bytes; code: HCOMP */
static int pred_init(Pred *pr, int n, const U8 *comps, const U8 *code,
                     int codelen, int hh, int hm) {
    memset(pr, 0, sizeof *pr);
    if (vm_init(&pr->z, code, codelen, hh, hm, NULL)) return -1;
    pr->n = n;
    pr->c8 = 1;
    pr->hmap4 = 1;
    const U8 *cp = comps;
    for (int i = 0; i < n; ++i) {
        Comp *c = &pr->comp[i];
        c->cp = cp;
        switch (cp[0]) {
        case CONS:
            pr->p[i] = (cp[1] - 128) * 4;
            break;
        case CM:
            if (cp[1] > 30 || !cm_alloc(c, (size_t)1 << cp[1])) return -1;
            for (U32 j = 0; j <= c->cmmask; ++j) c->cm[j] = 0x80000000u;
            c->limit = cp[2] * 4u;
            break;
        case ICM:
            if (cp[1] > 26 || !cm_alloc(c, 256)
                || !ht_alloc(c, (size_t)64 << cp[1]))
                return -1;
            for (int j = 0; j < 256; ++j) c->cm[j] = cminit_t[j];
            c->limit = 1023;
            break;
        case MATCH:
            if (cp[1] > 30 || cp[2] > 30 || !cm_alloc(c, (size_t)1 << cp[1])
                || !ht_alloc(c, (size_t)1 << cp[2]))
                return -1;
            c->ht[0] = 1;
            break;
        case AVG:
            if (cp[1] >= i || cp[2] >= i) return -1;
            break;
        case MIX2:
            if (cp[1] > 30 || cp[2] >= i || cp[3] >= i) return -1;
            c->c = 1u << cp[1];
            c->a16 = malloc(sizeof(U16) << cp[1]);
            if (!c->a16) return -1;
            for (U32 j = 0; j < c->c; ++j) c->a16[j] = 32768;
            break;
        case MIX: {
            int m = cp[3];
            if (cp[1] > 24 || m < 1 || cp[2] + m > i) return -1;
            c->c = 1u << cp[1];
            if (!cm_alloc(c, (size_t)m << cp[1])) return -1;
            for (U32 j = 0; j <= c->cmmask; ++j) c->cm[j] = 65536 / m;
            break;
        }
        case ISSE:
            if (cp[1] > 26 || cp[2] >= i || !cm_alloc(c, 512)
                || !ht_alloc(c, (size_t)64 << cp[1]))
                return -1;
            for (int j = 0; j < 256; ++j) {
                c->cm[j * 2] = 1 << 15;
                c->cm[j * 2 + 1] =
                    (U32)clamp512k(stretch(cminit_t[j] >> 8) * 1024);
            }
            break;
        case SSE:
            if (cp[1] > 26 || cp[2] >= i
                || !cm_alloc(c, (size_t)32 << cp[1]))
                return -1;
            for (U32 j = 0; j <= c->cmmask; ++j)
                c->cm[j] = (U32)squash((int)(j & 31) * 64 - 992) << 17
                           | cp[3];
            c->limit = cp[4] * 4u;
            break;
        default:
            return -1;
        }
        cp += compsize[cp[0]];
    }
    return 0;
}

/* the row of bit histories for context cxt in ht (rows of 16: a check
 * byte, then 15 histories), replacing the least used of three rows */
static U32 find(Comp *c, int sizebits, U32 cxt) {
    U8 *ht = c->ht;
    U32 chk = cxt >> sizebits & 255;
    U32 h0 = (cxt * 16) & (c->htmask + 1 - 16);
    if (ht[h0] == chk) return h0;
    U32 h1 = h0 ^ 16;
    if (ht[h1] == chk) return h1;
    U32 h2 = h0 ^ 32;
    if (ht[h2] == chk) return h2;
    U32 r;
    if (ht[h0 + 1] <= ht[h1 + 1] && ht[h0 + 1] <= ht[h2 + 1]) r = h0;
    else if (ht[h1 + 1] < ht[h2 + 1]) r = h1;
    else r = h2;
    memset(ht + r, 0, 16);
    ht[r] = (U8)chk;
    return r;
}

static void train(Comp *c, int y) {
    U32 *pn = &c->cm[c->cxt & c->cmmask];
    U32 count = *pn & 0x3ff;
    int error = y * 32767 - (int)(*pn >> 17);
    *pn += (U32)(((I32)((int64_t)error * dt[count])) & -1024)
           + (count < c->limit);
}

/* P(next bit is 1), 16 bits, odd */
static int predict(Pred *pr) {
    int *p = pr->p;
    U32 c8 = pr->c8, hmap4 = pr->hmap4;
    for (int i = 0; i < pr->n; ++i) {
        Comp *c = &pr->comp[i];
        const U8 *cp = c->cp;
        switch (cp[0]) {
        case CONS:
            break;
        case CM:
            c->cxt = pr->h[i] ^ hmap4;
            p[i] = stretch(c->cm[c->cxt & c->cmmask] >> 17);
            break;
        case ICM:
            if (c8 == 1 || (c8 & 0xf0) == 16)
                c->c = find(c, cp[1] + 2, pr->h[i] + 16 * c8);
            c->cxt = c->ht[c->c + (hmap4 & 15)];
            p[i] = stretch(c->cm[c->cxt] >> 8);
            break;
        case MATCH:
            if (c->a == 0) {
                p[i] = 0;
            } else {
                c->c = (c->ht[(c->limit - c->b) & c->htmask] >> (7 - c->cxt))
                       & 1;
                p[i] = stretch(dt2k[c->a] * (1 - 2 * (int)c->c) & 32767);
            }
            break;
        case AVG:
            p[i] = (p[cp[1]] * cp[3] + p[cp[2]] * (256 - cp[3])) >> 8;
            break;
        case MIX2: {
            c->cxt = (pr->h[i] + (c8 & cp[5])) & (c->c - 1);
            int w = c->a16[c->cxt];
            p[i] = (w * p[cp[2]] + (65536 - w) * p[cp[3]]) >> 16;
            break;
        }
        case MIX: {
            int m = cp[3];
            c->cxt = ((pr->h[i] + (c8 & cp[5])) & (c->c - 1)) * m;
            const I32 *wt = (const I32 *)&c->cm[c->cxt];
            int s = 0;
            for (int j = 0; j < m; ++j) s += (wt[j] >> 8) * p[cp[2] + j];
            p[i] = clamp2k(s >> 8);
            break;
        }
        case ISSE: {
            if (c8 == 1 || (c8 & 0xf0) == 16)
                c->c = find(c, cp[1] + 2, pr->h[i] + 16 * c8);
            c->cxt = c->ht[c->c + (hmap4 & 15)];
            const I32 *wt = (const I32 *)&c->cm[c->cxt * 2];
            p[i] = clamp2k((wt[0] * p[cp[2]] + wt[1] * 64) >> 16);
            break;
        }
        case SSE: {
            c->cxt = (pr->h[i] + c8) * 32;
            int pq = p[cp[2]] + 992;
            if (pq < 0) pq = 0;
            if (pq > 1983) pq = 1983;
            int wt = pq & 63;
            pq >>= 6;
            c->cxt += pq;
            p[i] = stretch(
                (int)(((c->cm[c->cxt & c->cmmask] >> 10) * (U32)(64 - wt)
                       + (c->cm[(c->cxt + 1) & c->cmmask] >> 10) * (U32)wt)
                      >> 13));
            c->cxt += wt >> 5;
            break;
        }
        }
    }
    return squash(p[pr->n - 1]) * 2 + 1;
}

static int update(Pred *pr, int y) {
    int *p = pr->p;
    for (int i = 0; i < pr->n; ++i) {
        Comp *c = &pr->comp[i];
        const U8 *cp = c->cp;
        switch (cp[0]) {
        case CONS:
        case AVG:
            break;
        case CM:
        case SSE:
            train(c, y);
            break;
        case ICM: {
            U8 *hp = &c->ht[c->c + (pr->hmap4 & 15)];
            *hp = ns[*hp * 4 + y];
            U32 *pn = &c->cm[c->cxt];
            *pn += (U32)((y * 32767 - (int)(*pn >> 8)) >> 2);
            break;
        }
        case MATCH: {
            if ((int)c->c != y) c->a = 0;
            U8 *cur = &c->ht[c->limit & c->htmask];
            *cur = (U8)(*cur + *cur + y);
            if (++c->cxt == 8) {
                c->cxt = 0;
                c->limit = (c->limit + 1) & c->htmask;
                U32 *ptr = &c->cm[pr->h[i] & c->cmmask];
                if (c->a == 0) {
                    c->b = c->limit - *ptr;
                    if (c->b & c->htmask)
                        while (c->a < 255
                               && c->ht[(c->limit - c->a - 1) & c->htmask]
                                      == c->ht[(c->limit - c->a - c->b - 1)
                                               & c->htmask])
                            ++c->a;
                } else {
                    c->a += c->a < 255;
                }
                *ptr = c->limit;
            }
            break;
        }
        case MIX2: {
            int err = (y * 32767 - squash(p[i])) * cp[4] >> 5;
            int w = c->a16[c->cxt];
            w += (err * (p[cp[2]] - p[cp[3]]) + (1 << 12)) >> 13;
            if (w < 0) w = 0;
            if (w > 65535) w = 65535;
            c->a16[c->cxt] = (U16)w;
            break;
        }
        case MIX: {
            int m = cp[3];
            int err = (y * 32767 - squash(p[i])) * cp[4] >> 4;
            I32 *wt = (I32 *)&c->cm[c->cxt];
            for (int j = 0; j < m; ++j)
                wt[j] = clamp512k(wt[j] + ((err * p[cp[2] + j] + (1 << 12))
                                           >> 13));
            break;
        }
        case ISSE: {
            int err = y * 32767 - squash(p[i]);
            I32 *wt = (I32 *)&c->cm[c->cxt * 2];
            wt[0] = clamp512k(wt[0] + ((err * p[cp[2]] + (1 << 12)) >> 13));
            wt[1] = clamp512k(wt[1] + ((err + 0x10) >> 5));
            c->ht[c->c + (pr->hmap4 & 15)] = ns[c->cxt * 4 + y];
            break;
        }
        }
    }
    pr->c8 += pr->c8 + y;
    if (pr->c8 >= 256) {
        if (vm_run(&pr->z, pr->c8 - 256)) return -1;
        pr->hmap4 = 1;
        pr->c8 = 1;
        for (int i = 0; i < pr->n; ++i) pr->h[i] = pr->z.h[i & pr->z.hmask];
    } else if (pr->c8 >= 16 && pr->c8 < 32) {
        pr->hmap4 = (pr->hmap4 & 0xf) << 5 | (U32)y << 4 | 1;
    } else {
        pr->hmap4 = (pr->hmap4 & 0x1f0) | (((pr->hmap4 & 0xf) * 2 + y) & 0xf);
    }
    return 0;
}

/* ---- the arithmetic decoder ---------------------------------------------- */

typedef struct {
    const U8 *in;
    size_t pos, end;
    U32 low, high, curr;
} Dec;

static int get(Dec *d) { return d->pos < d->end ? d->in[d->pos++] : -1; }

/* one bit with P(1) = p / 65536; -1 on a corrupt stream */
static int decode_bit(Dec *d, int p) {
    if (d->curr < d->low || d->curr > d->high) return -1;
    U32 mid = d->low + (U32)(((uint64_t)(d->high - d->low) * (U32)p) >> 16);
    int y;
    if (d->curr <= mid) {
        y = 1;
        d->high = mid;
    } else {
        y = 0;
        d->low = mid + 1;
    }
    while ((d->high ^ d->low) < 0x1000000) {
        d->high = d->high << 8 | 255;
        d->low = d->low << 8;
        d->low += (d->low == 0);
        int c = get(d);
        if (c < 0) return -1;
        d->curr = d->curr << 8 | (U32)c;
    }
    return y;
}

/* the next byte of the segment, -1 at its end, -2 on an error */
static int next_byte(Dec *d, Pred *pr) {
    if (pr->n) {
        if (d->curr == 0) {
            for (int i = 0; i < 4; ++i) {
                int c = get(d);
                if (c < 0) return -2;
                d->curr = d->curr << 8 | (U32)c;
            }
        }
        int e = decode_bit(d, 0);
        if (e < 0) return -2;
        if (e) return d->curr == 0 ? -1 : -2;
        int c = 1;
        while (c < 256) {
            int y = decode_bit(d, predict(pr));
            if (y < 0) return -2;
            c += c + y;
            if (update(pr, y)) return -2;
        }
        return c - 256;
    }
    if (d->curr == 0) {
        for (int i = 0; i < 4; ++i) {
            int c = get(d);
            if (c < 0) return -2;
            d->curr = d->curr << 8 | (U32)c;
        }
        if (d->curr == 0) return -1;
    }
    --d->curr;
    return get(d) < 0 ? -2 : d->in[d->pos - 1];
}

/* ---- the postprocessor ---------------------------------------------------- */

typedef struct {
    int state;        /* 0 first byte, 1 pass, 2-3 size, 4 code, 5 run */
    int size, ph, pm;
    U8 code[65536];
    int have;
    VM z;
    Buf *out;
} Post;

static int post_write(Post *pp, int c) {
    switch (pp->state) {
    case 0:
        if (c < 0 || c > 1) return -1;
        pp->state = c + 1;
        return 0;
    case 1:
        if (c >= 0) put(pp->out, (U8)c);
        return 0;
    case 2:
        if (c < 0) return -1;
        pp->size = c;
        pp->state = 3;
        return 0;
    case 3:
        if (c < 0) return -1;
        pp->size += c * 256;
        if (pp->size < 1) return -1;
        pp->have = 0;
        pp->state = 4;
        return 0;
    case 4:
        if (c < 0) return -1;
        pp->code[pp->have++] = (U8)c;
        if (pp->have == pp->size) {
            if (vm_init(&pp->z, pp->code, pp->size, pp->ph, pp->pm, pp->out))
                return -1;
            pp->state = 5;
        }
        return 0;
    default:
        return vm_run(&pp->z, (U32)c);
    }
}

/* ---- blocks --------------------------------------------------------------- */

static const U8 TAG[13] = {0x37, 0x6B, 0x53, 0x74, 0xA0, 0x31, 0x83,
                           0xD3, 0x8C, 0xB2, 0x28, 0xB0, 0xD3};

static int fail(char *err, const char *what, size_t at) {
    snprintf(err, 160, "%s at %zu", what, at);
    return -1;
}

/* Decodes the block at buf[off] (its locator tag first): the bytes of all
 * its segments, postprocessed, into *out (malloc'ed, *outlen bytes; on
 * an error, what was decoded before it). Returns 0, or -1 with a reason
 * in err (160 bytes). */
int zd_block(const U8 *buf, size_t len, size_t off, U8 **out,
             size_t *outlen, char *err) {
    size_t p = off;
    Buf o = {0};
    Pred *pr = NULL;
    Post *pp = NULL;
    int rc = -1;
    *out = NULL;
    *outlen = 0;
    if (p + 20 > len || memcmp(buf + p, TAG, 13)
        || memcmp(buf + p + 13, "zPQ", 3))
        return fail(err, "no block", off);
    if ((buf[p + 16] != 1 && buf[p + 16] != 2) || buf[p + 17] != 1)
        return fail(err, "unknown level", off);
    p += 18;
    int hsize = buf[p] | buf[p + 1] << 8;
    const U8 *hdr = buf + p + 2;
    if (p + 2 + (size_t)hsize > len || hsize < 7)
        return fail(err, "short header", off);
    int hh = hdr[0], hm = hdr[1], ph = hdr[2], pm = hdr[3], n = hdr[4];
    int q = 5;
    for (int i = 0; i < n; ++i) {
        if (q >= hsize || hdr[q] < 1 || hdr[q] > 9)
            return fail(err, "bad component", off);
        q += compsize[hdr[q]];
    }
    if (q >= hsize || hdr[q] != 0) return fail(err, "no COMP end", off);
    ++q;
    if (hdr[hsize - 1] != 0) return fail(err, "no HCOMP end", off);
    pr = malloc(sizeof *pr);
    pp = calloc(1, sizeof *pp);
    if (!pr || !pp) goto done;
    memset(pr, 0, sizeof *pr);
    if (pred_init(pr, n, hdr + 5, hdr + q, hsize - q, hh, hm)) {
        fail(err, "model", off);
        goto done;
    }
    pp->ph = ph;
    pp->pm = pm;
    pp->out = &o;
    p += 2 + (size_t)hsize;
    Dec d = {buf, p, len, 1, 0xFFFFFFFFu, 0};
    for (;;) {
        if (d.pos >= len) {
            fail(err, "no block end", d.pos);
            goto done;
        }
        int c = buf[d.pos++];
        if (c == 255) break;
        if (c != 1) {
            fail(err, "no segment", d.pos - 1);
            goto done;
        }
        for (int k = 0; k < 2; ++k) {       /* name, comment */
            while (d.pos < len && buf[d.pos]) ++d.pos;
            ++d.pos;
        }
        if (d.pos >= len || buf[d.pos++] != 0) {
            fail(err, "reserved byte", d.pos);
            goto done;
        }
        for (;;) {
            int b = next_byte(&d, pr);
            if (b == -2) {
                fail(err, "corrupt data", d.pos);
                goto done;
            }
            if (post_write(pp, b)) {
                fail(err, "postprocessor", d.pos);
                goto done;
            }
            if (b == -1) break;
        }
        if (d.pos >= len) {
            fail(err, "no segment end", d.pos);
            goto done;
        }
        c = buf[d.pos++];
        if (c == 253) d.pos += 20;
        else if (c != 254) {
            fail(err, "bad segment end", d.pos - 1);
            goto done;
        }
    }
    if (o.oom) {
        fail(err, "out of memory", off);
        goto done;
    }
    rc = 0;
done:
    if (pr) pred_free(pr);
    if (pp) {
        vm_free(&pp->z);
        free(pp);
    }
    free(pr);
    *out = o.p;
    *outlen = o.n;
    return rc;
}

void zd_free(U8 *p) { free(p); }
