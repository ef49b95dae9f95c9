// Native host data path: FASTA parsing + IUPAC encoding.
//
// The reference links libARBDB and uses boost::iostreams for its host
// IO (SINA src/rw_fasta.cpp); here the sequence data path
// is a single-pass C++ scanner producing the framework's packed
// (position, bitmask) arrays directly, callable through ctypes.
//
// Encoding matches sina_tpu/alphabet.py (aligned_base.cpp:70-107
// semantics): 4-bit base bitmask + lowercase bit; '-' and '.' advance
// the column counter without emitting a base; whitespace is skipped.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Tables {
    unsigned char mask[256];
    bool valid[256];   // IUPAC code or gap
    Tables() {
        std::memset(mask, 0, sizeof(mask));
        std::memset(valid, 0, sizeof(valid));
        struct { char c; unsigned char m; } codes[] = {
            {'A', 1},  {'G', 2},  {'C', 4},  {'T', 8},  {'U', 8},
            {'R', 3},  {'Y', 12}, {'K', 10}, {'M', 5},  {'S', 6},
            {'W', 9},  {'B', 14}, {'D', 11}, {'H', 13}, {'V', 7},
            {'N', 15},
        };
        for (auto& cm : codes) {
            mask[(unsigned char)cm.c] = cm.m;
            mask[(unsigned char)(cm.c + 32)] = cm.m | 16;
            valid[(unsigned char)cm.c] = true;
            valid[(unsigned char)(cm.c + 32)] = true;
        }
        valid[(unsigned char)'-'] = true;
        valid[(unsigned char)'.'] = true;
    }
};

const Tables T;

inline bool is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n';
}

}  // namespace

extern "C" {

// Returns 1 if the buffer contains FASTA comment lines (';' at line
// start) — the caller should use the attribute-aware python reader.
long sina_fasta_has_comments(const char* buf, long len) {
    if (len > 0 && buf[0] == ';') return 1;
    for (long i = 1; i < len; ++i) {
        if (buf[i] == ';' && buf[i - 1] == '\n') return 1;
    }
    return 0;
}

// Single-pass FASTA parse.
//
// Outputs (caller-allocated):
//   masks[cap_bases], positions[cap_bases]  packed base data
//   base_offsets[max_recs+1]                per-record base ranges
//   widths[max_recs]                        alignment width per record
//   header_offsets[2*max_recs]              (start, end) byte ranges of
//                                           each '>' header (sans '>')
//   flags[max_recs]                         1 = bad character, skip
//
// Returns the number of records, or -1 if capacities were exceeded.
long sina_parse_fasta(
    const char* buf, long len,
    unsigned char* masks, unsigned int* positions, long cap_bases,
    long* base_offsets, long* widths,
    long* header_offsets, unsigned char* flags, long max_recs) {
    long nrec = -1;       // current record index
    long nbases = 0;
    long width = 0;
    bool in_header = false;
    base_offsets[0] = 0;

    long i = 0;
    while (i < len) {
        char c = buf[i];
        if (c == '>' && (i == 0 || buf[i - 1] == '\n')) {
            if (nrec >= 0) {
                widths[nrec] = width;
                base_offsets[nrec + 1] = nbases;
            }
            ++nrec;
            if (nrec >= max_recs) return -1;
            flags[nrec] = 0;
            width = 0;
            // header spans to end of line
            long start = i + 1;
            long j = start;
            while (j < len && buf[j] != '\n') ++j;
            long end = j;
            if (end > start && buf[end - 1] == '\r') --end;
            header_offsets[2 * nrec] = start;
            header_offsets[2 * nrec + 1] = end;
            i = j + 1;
            continue;
        }
        if (nrec < 0) { ++i; continue; }  // preamble junk
        // sequence data line
        long j = i;
        while (j < len && buf[j] != '\n') {
            unsigned char ch = (unsigned char)buf[j];
            if (!is_ws(ch)) {
                if (!T.valid[ch]) {
                    flags[nrec] = 1;
                } else {
                    unsigned char m = T.mask[ch];
                    if (m != 0) {
                        if (nbases >= cap_bases) return -1;
                        masks[nbases] = m;
                        positions[nbases] = (unsigned int)width;
                        ++nbases;
                    }
                    ++width;
                }
            }
            ++j;
        }
        i = j + 1;
    }
    if (nrec >= 0) {
        widths[nrec] = width;
        base_offsets[nrec + 1] = nbases;
    }
    return nrec + 1;
}

// Batched pseq profile construction (pseq.cpp:44-115 semantics;
// parity-tested against the python build_profile).  Inputs are the
// concatenated base arrays of every family member in bucket order;
// outputs are the padded per-family profiles.
//
//   all_pos[]          alignment column of each base (flat store)
//   all_mask[]         IUPAC 4-bit mask of each base (flat store)
//   member_starts[n_total]  offset of each member's bases
//   base_counts[n_total]    bases per member
//   fam_sizes[B]       members per family
//   freqs[B*cpad*4], gapo_out[B*cpad], gape_out[B*cpad]  (zeroed)
//   cols_flat[B*cpad]  occupied columns per family
//   c_real[B]          occupied-column counts
//
// Returns 0, or -1 if a family has more occupied columns than cpad.
//
// Two output modes share the core: f32 (freqs/gapo_out/gape_out) and
// device-quantised (fgq, 6 bytes/column — the _pack_fgq wire format:
// 4 bytes rint(freq*255) + int16 rint(gapcost*gap_scale), gapcost =
// gap_open*gapo + gap_ext*gape in f32 op order, bit-exact vs the
// python quantiser, see ops/profile.py:_pack_fgq).  Building packed
// directly skips the (B,cpad,4) f32 materialisation + the python
// gapcost/pack passes — ~0.7ms/seq of host wall on the bench host.
static long build_profiles_core(
    const unsigned int* all_pos, const unsigned char* all_mask,
    const long long* member_starts, const long long* base_counts,
    const long long* fam_sizes,
    long B, long width, long cpad,
    float* freqs, float* gapo_out, float* gape_out,
    unsigned char* fgq, float go_w, float ge_w, float gap_scale,
    int* cols_flat, long long* c_real) {
    // 12 points split over a mask's letters (pseq.cpp:56-63)
    double wtab[16];
    for (int m = 0; m < 16; ++m) {
        int pc = __builtin_popcount((unsigned)m);
        wtab[m] = 12.0 / (pc > 0 ? pc : 1);
    }
    std::vector<long long> fam_cursor((size_t)B + 1, 0);
    for (long b = 0; b < B; ++b)
        fam_cursor[b + 1] = fam_cursor[b] + fam_sizes[b];
    // families parallelise cleanly (outputs are disjoint b-slices;
    // per-thread scratch) — the serial loop was 0.11 s/batch of the
    // r5 100k steady state on the 2-core bench host
    std::atomic<long> next(0);
    std::atomic<long> err(0);
    auto worker = [&]() {
        std::vector<double> pts((size_t)width * 4);
        std::vector<unsigned> stamp((size_t)width, 0xFFFFFFFFu);
        std::vector<int> colindex(width);
        std::vector<int> present(cpad), gapo(cpad);
        for (;;) {
            long b = next.fetch_add(1);
            if (b >= B || err.load(std::memory_order_relaxed)) break;
            long seq_cursor = (long)fam_cursor[b];
            long nm = fam_sizes[b];
            unsigned st = (unsigned)b;
            for (long m = 0; m < nm; ++m) {
                long cur = member_starts[seq_cursor + m];
                long cnt = base_counts[seq_cursor + m];
                for (long k = 0; k < cnt; ++k, ++cur) {
                    unsigned mask = all_mask[cur] & 0xF;
                    if (!mask) continue;
                    double w = wtab[mask];
                    unsigned int p = all_pos[cur];
                    double* row = &pts[(size_t)p * 4];
                    if (stamp[p] != st) {
                        // epoch stamp: zero lazily instead of a
                        // width*4 memset per family
                        stamp[p] = st;
                        row[0] = row[1] = row[2] = row[3] = 0.0;
                    }
                    if (mask & 1) row[0] += w;
                    if (mask & 2) row[1] += w;
                    if (mask & 4) row[2] += w;
                    if (mask & 8) row[3] += w;
                }
            }
            long C = 0;
            bool overflow = false;
            for (long col = 0; col < width; ++col) {
                if (stamp[col] != st) continue;
                const double* row = &pts[(size_t)col * 4];
                if (row[0] + row[1] + row[2] + row[3] > 0.0) {
                    if (C >= cpad) { overflow = true; break; }
                    colindex[col] = (int)C;
                    cols_flat[b * cpad + C] = (int)col;
                    ++C;
                }
            }
            if (overflow) { err.store(1); break; }
            c_real[b] = C;
            std::fill(present.begin(), present.begin() + C, 0);
            std::fill(gapo.begin(), gapo.begin() + C, 0);
            // gap transitions per member: absent at column c counts
            // as OPEN when the member is present at c-1, else EXTEND
            // (pseq.cpp:71-100; the leading gap flag starts true)
            for (long m = 0; m < nm; ++m) {
                long cur = member_starts[seq_cursor + m];
                long cnt = base_counts[seq_cursor + m];
                long prev = -2;
                for (long k = 0; k < cnt; ++k, ++cur) {
                    unsigned mask = all_mask[cur] & 0xF;
                    if (!mask) continue;
                    int ci = colindex[all_pos[cur]];
                    if (prev >= 0 && ci != prev + 1) ++gapo[prev + 1];
                    ++present[ci];
                    prev = ci;
                }
                if (prev >= 0 && prev + 1 < C) ++gapo[prev + 1];
            }
            for (long c = 0; c < C; ++c) {
                long col = cols_flat[b * cpad + c];
                const double* row = &pts[(size_t)col * 4];
                double go = gapo[c];
                double ge = (double)(nm - present[c]) - go;
                double total =
                    row[0] + row[1] + row[2] + row[3]
                    + 12.0 * (go + ge);
                if (total < 1e-9) total = 1e-9;
                float f0 = (float)(row[0] / total);
                float f1 = (float)(row[1] / total);
                float f2 = (float)(row[2] / total);
                float f3 = (float)(row[3] / total);
                float gof = (float)(12.0 * go / total);
                float gef = (float)(12.0 * ge / total);
                if (fgq != nullptr) {
                    unsigned char* o =
                        &fgq[((size_t)b * cpad + c) * 6];
                    // rintf = round-half-to-even, matching np.rint
                    o[0] = (unsigned char)(int)rintf(f0 * 255.0f);
                    o[1] = (unsigned char)(int)rintf(f1 * 255.0f);
                    o[2] = (unsigned char)(int)rintf(f2 * 255.0f);
                    o[3] = (unsigned char)(int)rintf(f3 * 255.0f);
                    float gc = go_w * gof + ge_w * gef;
                    short gi = (short)rintf(gc * gap_scale);
                    std::memcpy(o + 4, &gi, 2);
                } else {
                    float* fr = &freqs[((size_t)b * cpad + c) * 4];
                    fr[0] = f0;
                    fr[1] = f1;
                    fr[2] = f2;
                    fr[3] = f3;
                    gapo_out[b * cpad + c] = gof;
                    gape_out[b * cpad + c] = gef;
                }
            }
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    long nt = hw > 1 ? (long)hw : 1;
    if (nt > B) nt = B > 0 ? B : 1;
    std::vector<std::thread> threads;
    for (long t = 1; t < nt; ++t) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
    return err.load() ? -1 : 0;
}

long sina_build_profiles(
    const unsigned int* all_pos, const unsigned char* all_mask,
    const long long* member_starts, const long long* base_counts,
    const long long* fam_sizes,
    long n_total, long B, long width, long cpad,
    float* freqs, float* gapo_out, float* gape_out,
    int* cols_flat, long long* c_real) {
    (void)n_total;
    return build_profiles_core(
        all_pos, all_mask, member_starts, base_counts, fam_sizes,
        B, width, cpad, freqs, gapo_out, gape_out,
        nullptr, 0.0f, 0.0f, 0.0f, cols_flat, c_real);
}

long sina_build_profiles_packed(
    const unsigned int* all_pos, const unsigned char* all_mask,
    const long long* member_starts, const long long* base_counts,
    const long long* fam_sizes,
    long B, long width, long cpad,
    unsigned char* fgq, float gap_open, float gap_ext,
    float gap_scale,
    int* cols_flat, long long* c_real) {
    return build_profiles_core(
        all_pos, all_mask, member_starts, base_counts, fam_sizes,
        B, width, cpad, nullptr, nullptr, nullptr,
        fgq, gap_open, gap_ext, gap_scale, cols_flat, c_real);
}

// Per-member base subranges covering a per-family raw-column window
// [lo, hi) (lo < 0 = keep the full member).  Member positions are
// ascending (cseq invariant), so each restriction is two binary
// searches.  Feeds window-restricted profile builds: an amplicon
// batch otherwise pays the FULL family profile build (~70% of the
// bases land outside every query's window).
long sina_member_ranges(
    const unsigned int* all_pos,
    const long long* member_starts, const long long* base_counts,
    const long long* fam_sizes,
    const long long* lo, const long long* hi,
    long B,
    long long* out_starts, long long* out_counts) {
    long cursor = 0;
    for (long b = 0; b < B; ++b) {
        long nm = fam_sizes[b];
        for (long m = 0; m < nm; ++m, ++cursor) {
            long long s = member_starts[cursor];
            long long c = base_counts[cursor];
            if (lo[b] < 0) {
                out_starts[cursor] = s;
                out_counts[cursor] = c;
                continue;
            }
            const unsigned int* p0 = all_pos + s;
            const unsigned int* pl = std::lower_bound(
                p0, p0 + c, (unsigned int)lo[b]);
            const unsigned int* ph = std::lower_bound(
                pl, p0 + c, (unsigned int)hi[b]);
            out_starts[cursor] = s + (pl - p0);
            out_counts[cursor] = ph - pl;
        }
    }
    return 0;
}

// Batched occupied-column counts per family (the bucketing input for
// align_dispatch): counts[b] = |union of member base columns|.  An
// epoch-stamped scratch array avoids clearing width slots per family.
//
//   all_pos[]               alignment column of each base (flat store)
//   member_starts/base_counts  per-member base ranges (as above)
//   fam_sizes[B]            members per family
//   counts[B]               output occupied-column counts
//
// Returns 0, or -1 on an out-of-range column (caller falls back).
long sina_count_cols(
    const unsigned int* all_pos,
    const long long* member_starts, const long long* base_counts,
    const long long* fam_sizes,
    long B, long width,
    long long* counts) {
    std::vector<int> stamp((size_t)width, -1);
    long seq_cursor = 0;
    for (long b = 0; b < B; ++b) {
        long nm = fam_sizes[b];
        long long C = 0;
        for (long m = 0; m < nm; ++m) {
            long long cur = member_starts[seq_cursor + m];
            long long cnt = base_counts[seq_cursor + m];
            for (long long k = 0; k < cnt; ++k, ++cur) {
                unsigned int p = all_pos[cur];
                if (p >= (unsigned int)width) return -1;
                if (stamp[p] != (int)b) {
                    stamp[p] = (int)b;
                    ++C;
                }
            }
        }
        counts[b] = C;
        seq_cursor += nm;
    }
    return 0;
}

// Occupied-column count restricted to a per-family raw-column window
// [lo, hi): the exact shape-bucketing input for column-trimmed
// profile DP rows.  The whole-db rank estimate over-counts by the
// db/family column-density ratio (a 791-col window was bucketing at
// 1024 instead of 512 on the amplicon bench); this counts the
// family's own columns inside the window.
long sina_count_cols_range(
    const unsigned int* all_pos,
    const long long* member_starts, const long long* base_counts,
    const long long* fam_sizes,
    const long long* lo, const long long* hi,
    long B, long width,
    long long* counts) {
    std::vector<int> stamp((size_t)width, -1);
    long seq_cursor = 0;
    for (long b = 0; b < B; ++b) {
        long nm = fam_sizes[b];
        long long C = 0;
        unsigned int l = (unsigned int)lo[b];
        unsigned int h = (unsigned int)hi[b];
        for (long m = 0; m < nm; ++m) {
            long long cur = member_starts[seq_cursor + m];
            long long cnt = base_counts[seq_cursor + m];
            for (long long k = 0; k < cnt; ++k, ++cur) {
                unsigned int p = all_pos[cur];
                if (p >= (unsigned int)width) return -1;
                if (p >= l && p < h && stamp[p] != (int)b) {
                    stamp[p] = (int)b;
                    ++C;
                }
            }
        }
        counts[b] = C;
        seq_cursor += nm;
    }
    return 0;
}

// Batched query column-window anchoring (the native core of
// ops/colspan.query_window; see that module for the full
// derivation).  Per query: extract valid 12-mers, probe the top
// reference's sorted k-mer table, build the diagonal-consensus
// anchor set (all occurrences per matched k-mer, capped), take the
// median offset, drop outliers beyond the indel budget, widen the
// base window by the slack terms and convert to raw columns plus
// occupied-rank edge slack.  The python loop cost ~0.45 ms/query
// of host wall at amplicon batch shapes — pure small-numpy call
// overhead.
//
//   qmasks/qoffsets        flat query masks (B queries)
//   tbl_vals/tbl_pos       concatenated sorted tables (int64 kmer
//                          values / int64 base positions)
//   tbl_offsets[(T+1)]     table t = tbl_*[tbl_offsets[t] : t+1]
//   tbl_nbases[T]          top reference base counts
//   rpos_flat/rpos_offsets top reference per-base columns (uint32)
//   qtable[B]              table index per query (-1 = skip)
//   cols[n_cols]           ascending occupied columns (whole db)
//   out[B*3]               lo_col, hi_col, est ranks (-1 = no window)
long sina_query_windows(
    const unsigned char* qmasks, const long long* qoffsets,
    long B,
    const long long* tbl_vals, const long long* tbl_pos,
    const long long* tbl_offsets, const long long* tbl_nbases,
    const unsigned int* rpos_flat, const long long* rpos_offsets,
    const long long* qtable,
    const long long* cols, long n_cols,
    long k,
    long long* out, long n_threads) {
    const long MIN_ANCHORS = 3;
    const long MAX_OCC = 4;
    const double DIAG_SLACK_FRAC = 0.25;
    const long DIAG_SLACK_MIN = 100;
    const double BASE_SLACK_FRAC = 0.08;
    const long BASE_SLACK_MIN = 24;
    const long EDGE_SLACK_COLS = 32;
    std::atomic<long> next(0);
    auto worker = [&]() {
        std::vector<long long> qv, qp, rp, qpm, off;
        for (;;) {
            long b = next.fetch_add(1);
            if (b >= B) break;
            out[b * 3] = -1;
            out[b * 3 + 1] = -1;
            out[b * 3 + 2] = -1;
            long t = (long)qtable[b];
            if (t < 0) continue;
            long long qlo = qoffsets[b], qhi = qoffsets[b + 1];
            long long qlen = qhi - qlo;
            if (qlen < k) continue;
            // valid k-mers: windows of unambiguous bases
            qv.clear(); qp.clear();
            long long val = 0, run = 0;
            const long long mask_k =
                ((long long)1 << (2 * k)) - 1;
            for (long long i = 0; i < qlen; ++i) {
                unsigned m = qmasks[qlo + i] & 0xF;
                if (m && !(m & (m - 1))) {
                    long idx = 0;
                    while (!((m >> idx) & 1)) ++idx;
                    val = ((val << 2) | idx) & mask_k;
                    ++run;
                } else {
                    run = 0;
                    val = 0;
                }
                if (run >= k) {
                    qv.push_back(val);
                    qp.push_back(i - k + 1);
                }
            }
            if ((long)qv.size() < MIN_ANCHORS) continue;
            const long long* tv = tbl_vals + tbl_offsets[t];
            const long long* tp = tbl_pos + tbl_offsets[t];
            long long tn = tbl_offsets[t + 1] - tbl_offsets[t];
            rp.clear(); qpm.clear();
            long matched = 0;
            for (size_t i = 0; i < qv.size(); ++i) {
                const long long* lo =
                    std::lower_bound(tv, tv + tn, qv[i]);
                const long long* hi =
                    std::upper_bound(lo, tv + tn, qv[i]);
                if (hi > lo) ++matched;
                long long nocc = hi - lo;
                if (nocc > MAX_OCC) nocc = MAX_OCC;
                for (long long o = 0; o < nocc; ++o) {
                    rp.push_back(tp[(lo - tv) + o]);
                    qpm.push_back(qp[i]);
                }
            }
            if (matched < MIN_ANCHORS) continue;
            // median of offsets
            off.assign(rp.size(), 0);
            for (size_t i = 0; i < rp.size(); ++i)
                off[i] = rp[i] - qpm[i];
            std::vector<long long> tmp(off);
            size_t nmid = tmp.size() / 2;
            std::nth_element(tmp.begin(), tmp.begin() + nmid,
                             tmp.end());
            double med = (double)tmp[nmid];
            if (tmp.size() % 2 == 0) {
                long long lo2 = *std::max_element(
                    tmp.begin(), tmp.begin() + nmid);
                med = (med + (double)lo2) / 2.0;
            }
            long long slack = (long long)(DIAG_SLACK_FRAC * qlen);
            if (slack < DIAG_SLACK_MIN) slack = DIAG_SLACK_MIN;
            long kept = 0;
            long long rp_min = 0, rp_max = 0;
            long long qp_at_min = 0, qp_at_max = 0;
            for (size_t i = 0; i < rp.size(); ++i) {
                double d = (double)off[i] - med;
                if (d < 0) d = -d;
                if (d > (double)slack) continue;
                if (kept == 0 || rp[i] < rp_min) {
                    rp_min = rp[i];
                    qp_at_min = qpm[i];
                }
                if (kept == 0 || rp[i] > rp_max) {
                    rp_max = rp[i];
                    qp_at_max = qpm[i];
                }
                ++kept;
            }
            if (kept < MIN_ANCHORS) continue;
            long long base_slack =
                (long long)(BASE_SLACK_FRAC * qlen) + BASE_SLACK_MIN;
            long long lo_base = rp_min - qp_at_min - base_slack;
            long long hi_base =
                rp_max + (qlen - qp_at_max) + base_slack + k;
            if (lo_base < 0) lo_base = 0;
            long long nb = tbl_nbases[t];
            if (hi_base > nb - 1) hi_base = nb - 1;
            const unsigned int* rpos = rpos_flat + rpos_offsets[t];
            long long lo_col = rpos[lo_base];
            long long hi_col = rpos[hi_base];
            long long rlo =
                (long long)(std::lower_bound(cols, cols + n_cols,
                                             lo_col) - cols)
                - EDGE_SLACK_COLS;
            long long rhi =
                (long long)(std::upper_bound(cols, cols + n_cols,
                                             hi_col) - cols)
                + EDGE_SLACK_COLS;
            if (rlo < 0) rlo = 0;
            if (rhi > n_cols) rhi = n_cols;
            if (rhi <= rlo) continue;
            lo_col = cols[rlo];
            hi_col = cols[rhi - 1] + 1;
            out[b * 3] = lo_col;
            out[b * 3 + 1] = hi_col;
            out[b * 3 + 2] = rhi - rlo;
        }
    };
    long nt = n_threads > 0 ? n_threads : 1;
    if (nt > B) nt = B > 0 ? B : 1;
    std::vector<std::thread> threads;
    for (long tt = 1; tt < nt; ++tt) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
    return 0;
}

// Batched comparator counts for the search stage
// (cseq_comparator::traverse semantics, cseq_comparator.cpp:57-117):
// for each candidate reference, count matches/shared columns against
// a query column-mask plus span statistics.  The cover-rule and
// Jukes-Cantor math stays vectorised in numpy.
//
//   flat_pos/flat_masks/offsets  packed reference base store
//   ids[n_ids]                   candidate reference indices
//   qcol_mask[width+1]           query base mask per column (0 = none)
//   q_lo/q_hi                    query's first/last occupied column
//   iupac_rule                   0 optimistic, 1 pessimistic, 2 exact
//   filter_lc                    skip lowercase reference bases
//   out[n_ids*6]                 match, common, nb, b_in, r_lo, r_hi
static void score_counts_range(
    const unsigned int* flat_pos, const unsigned char* flat_masks,
    const long long* offsets,
    const long long* ids, long n_ids,
    const unsigned char* qcol_mask,
    long long q_lo, long long q_hi,
    long iupac_rule, long filter_lc,
    long long* out) {
    // popcount per low nibble for the pessimistic rule
    int pc[16];
    for (int m = 0; m < 16; ++m)
        pc[m] = __builtin_popcount((unsigned)m);
    for (long k = 0; k < n_ids; ++k) {
        long long r = ids[k];
        long long lo = offsets[r], hi = offsets[r + 1];
        long long match = 0, common = 0, nb = 0, b_in = 0;
        long long r_lo = -1, r_hi = -1;
        for (long long i = lo; i < hi; ++i) {
            unsigned char rm = flat_masks[i];
            if (filter_lc && (rm & 16)) continue;
            long long pos = flat_pos[i];
            if (r_lo < 0) r_lo = pos;
            r_hi = pos;
            ++nb;
            if (pos >= q_lo && pos <= q_hi) ++b_in;
            unsigned char qm = qcol_mask[pos];
            if (!qm) continue;
            ++common;
            unsigned q4 = qm & 0xF, r4 = rm & 0xF;
            bool ok;
            if (iupac_rule == 0) {
                ok = (q4 & r4) != 0;
            } else if (iupac_rule == 1) {
                ok = pc[q4] == 1 && q4 == r4;
            } else {
                ok = q4 == r4;
            }
            if (ok) ++match;
        }
        long long* row = &out[k * 6];
        row[0] = match;
        row[1] = common;
        row[2] = nb;
        row[3] = b_in;
        row[4] = r_lo;
        row[5] = r_hi;
    }
}

long sina_score_counts(
    const unsigned int* flat_pos, const unsigned char* flat_masks,
    const long long* offsets,
    const long long* ids, long n_ids,
    const unsigned char* qcol_mask,
    long long q_lo, long long q_hi,
    long iupac_rule, long filter_lc,
    long long* out) {
    score_counts_range(flat_pos, flat_masks, offsets, ids, n_ids,
                       qcol_mask, q_lo, q_hi, iupac_rule, filter_lc,
                       out);
    return 0;
}

// Multi-query batched comparator counts: the search stage rescans
// ~1000 candidates per query; one call scores the whole batch with
// queries distributed over threads (the per-query loop is the same
// traversal as sina_score_counts).
//   ids/id_offsets        flattened per-query candidate lists (CSR)
//   qcol_masks            (n_queries, stride) query column masks
//   q_lo/q_hi[n_queries]  per-query occupied spans
//   out                   (id_offsets[n_queries], 6)
long sina_score_counts_mq(
    const unsigned int* flat_pos, const unsigned char* flat_masks,
    const long long* offsets,
    const long long* ids, const long long* id_offsets,
    long n_queries,
    const unsigned char* qcol_masks, long long stride,
    const long long* q_lo, const long long* q_hi,
    long iupac_rule, long filter_lc,
    long long* out, long n_threads) {
    std::atomic<long> next(0);
    auto worker = [&]() {
        for (;;) {
            long q = next.fetch_add(1);
            if (q >= n_queries) break;
            long long lo = id_offsets[q], hi = id_offsets[q + 1];
            score_counts_range(
                flat_pos, flat_masks, offsets,
                ids + lo, (long)(hi - lo),
                qcol_masks + (long long)q * stride,
                q_lo[q], q_hi[q], iupac_rule, filter_lc,
                out + lo * 6);
        }
    };
    long nt = n_threads < 1 ? 1 : n_threads;
    std::vector<std::thread> threads;
    for (long t = 1; t < nt; ++t) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
    return 0;
}

// Parallel per-sequence unique-k-mer extraction over the flat base
// store — the index-build hot path (role of the reference's
// tbb::parallel_reduce IndexBuilder, kmer_search.cpp:152-211).
//
//   flat_masks[offsets[n_seqs]]  IUPAC bitmasks (low 4 bits used)
//   offsets[n_seqs+1]            per-sequence base ranges
//   k                            k-mer length
//   prefix_a                     1 = "fast" mode: keep only k-mers
//                                starting with A, emit the (k-1)-mer
//                                tail value (< 4^(k-1))
//   out_kmers[offsets[n_seqs]]   compacted CSR payload (sorted unique
//                                k-mers per sequence)
//   out_offsets[n_seqs+1]        CSR offsets into out_kmers
//
// Pass 1 writes each sequence's list at its bound offset (offsets[i])
// in parallel; pass 2 compacts serially (memmove-bound).
long sina_build_kmer_lists(
    const unsigned char* flat_masks, const long long* offsets,
    long n_seqs, long k, long prefix_a,
    int* out_kmers, long long* out_offsets, long n_threads) {
    if (k < 1 || k > 15) return -1;
    std::vector<long long> counts((size_t)n_seqs, 0);
    const unsigned int kmask =
        (k >= 16) ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1);
    const int shift_first = 2 * (int)(k - 1);

    auto worker = [&](std::atomic<long>* next) {
        std::vector<int> buf;
        for (;;) {
            long i = next->fetch_add(1);
            if (i >= n_seqs) break;
            long long lo = offsets[i], hi = offsets[i + 1];
            long long n = hi - lo;
            buf.clear();
            if (n >= k) {
                unsigned int val = 0;
                int run = 0;
                for (long long j = lo; j < hi; ++j) {
                    unsigned m = flat_masks[j] & 0xF;
                    // unambiguous = exactly one bit set
                    if (m && !(m & (m - 1))) {
                        val = ((val << 2) |
                               (unsigned)__builtin_ctz(m)) & kmask;
                        if (++run >= k) {
                            if (!prefix_a ||
                                (val >> shift_first) == 0)
                                buf.push_back((int)val);
                        }
                    } else {
                        run = 0;
                        val = 0;
                    }
                }
            }
            std::sort(buf.begin(), buf.end());
            buf.erase(std::unique(buf.begin(), buf.end()),
                      buf.end());
            counts[(size_t)i] = (long long)buf.size();
            std::memcpy(out_kmers + lo, buf.data(),
                        buf.size() * sizeof(int));
        }
    };

    long nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_seqs) nt = n_seqs > 0 ? n_seqs : 1;
    std::atomic<long> next(0);
    std::vector<std::thread> threads;
    for (long t = 1; t < nt; ++t)
        threads.emplace_back(worker, &next);
    worker(&next);
    for (auto& th : threads) th.join();

    out_offsets[0] = 0;
    for (long i = 0; i < n_seqs; ++i) {
        long long dst = out_offsets[i];
        long long src = offsets[i];
        if (dst != src && counts[(size_t)i])
            std::memmove(out_kmers + dst, out_kmers + src,
                         (size_t)counts[(size_t)i] * sizeof(int));
        out_offsets[i + 1] = dst + counts[(size_t)i];
    }
    return 0;
}

// Parallel bitpacked incidence-matrix fill from CSR k-mer lists:
// P[kmer_row, seq/8] |= 1 << (seq%8).
//
// Direct seq-major scatter thrashes TLB/caches on a multi-GB matrix
// (random row per posting).  Instead: counting-sort the postings into
// row-major order (compact int32 buffer), then fill P row-by-row in
// parallel with sequential writes.
long sina_fill_packed(
    const int* seq_kmers, const long long* seq_offsets,
    long n_seqs, unsigned char* P, long long row_bytes,
    long n_threads) {
    const long long total = seq_offsets[n_seqs];
    long long n_rows = 0;
    for (long long j = 0; j < total; ++j)
        if (seq_kmers[j] >= n_rows) n_rows = seq_kmers[j] + 1;
    // pass 1: per-row posting counts
    std::vector<long long> starts((size_t)n_rows + 1, 0);
    for (long long j = 0; j < total; ++j)
        ++starts[(size_t)seq_kmers[j] + 1];
    for (long long r = 0; r < n_rows; ++r)
        starts[(size_t)r + 1] += starts[(size_t)r];
    // pass 2: scatter sequence ids into row-major order
    std::vector<int> by_row((size_t)total);
    {
        std::vector<long long> cur(starts.begin(),
                                   starts.end() - 1);
        for (long s = 0; s < n_seqs; ++s)
            for (long long j = seq_offsets[s];
                 j < seq_offsets[s + 1]; ++j)
                by_row[(size_t)cur[(size_t)seq_kmers[j]]++] = (int)s;
    }
    // pass 3: parallel sequential row fill
    long nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_rows) nt = n_rows > 0 ? n_rows : 1;
    long long chunk = (n_rows + nt - 1) / nt;
    auto worker = [&](long t) {
        long long lo = t * chunk;
        long long hi = lo + chunk < n_rows ? lo + chunk : n_rows;
        for (long long r = lo; r < hi; ++r) {
            unsigned char* row = P + r * row_bytes;
            for (long long j = starts[(size_t)r];
                 j < starts[(size_t)r + 1]; ++j) {
                int s = by_row[(size_t)j];
                row[s >> 3] |= (unsigned char)(1u << (s & 7));
            }
        }
    };
    std::vector<std::thread> threads;
    for (long t = 1; t < nt; ++t) threads.emplace_back(worker, t);
    worker(0);
    for (auto& th : threads) th.join();
    return 0;
}

// Batched POA graph construction (mseq semantics, the host side of
// ops/graph.build_graph): one node per distinct (column, base-mask)
// pair, counts for the weight blend, edges by base succession with
// per-dst predecessor slots in ascending src order, start/end flags
// and the insertion budget.  Parallel over families.
//
// Family f's bases: all_pos/all_mask[member_starts[i] : +base_counts
// [i]] for its fam_sizes[f] members (flat base store).  Outputs are
// flat per-family regions at node_offsets[f] (caller precomputes
// offsets with capacity = family total bases): pos i32, mask u8,
// count i32, preds (cap, P) i32 (-1 pad), flags u8 (bit0 start, bit1
// end), max_insert i32.  n_nodes_out[f] = real node count.
long sina_build_graphs(
    const unsigned int* all_pos, const unsigned char* all_mask,
    const long long* member_starts, const long long* base_counts,
    const long long* fam_sizes, long n_fams,
    const long long* node_offsets,   // (n_fams+1,) capacity offsets
    long P,
    int* out_pos, unsigned char* out_mask, int* out_count,
    int* out_preds, unsigned char* out_flags, int* out_maxins,
    long long* n_nodes_out, long n_threads) {
    std::vector<long long> fam_first((size_t)n_fams + 1, 0);
    for (long f = 0, k = 0; f < n_fams; ++f) {
        fam_first[(size_t)f] = k;
        k += fam_sizes[f];
        fam_first[(size_t)f + 1] = k;
    }
    std::atomic<long> next(0);
    std::atomic<long> err(0);
    // Node keys are (pos << 4 | mask): flat-store masks are the
    // case-stripped low 4 IUPAC bits (refdb.ensure_flat), so the key
    // space is width*16 and nodes rank via an epoch-stamped direct
    // table instead of sort + per-base lower_bound; predecessors
    // insert straight into their <=P ascending slots instead of a
    // sorted-deduped edge array.  Same outputs, ~2-3x less work —
    // graph build was the top host-wall item of the graph engine.
    auto worker = [&]() {
        std::vector<int> stamp;            // epoch per key
        std::vector<int> id_of;            // node id per key
        std::vector<int> node_of;          // per base -> node id
        std::vector<long long> uniq;
        std::vector<unsigned char> has_succ;
        std::vector<int> minnext;
        std::vector<int> npred;
        int epoch = 0;
        for (;;) {
            long f = next.fetch_add(1);
            if (f >= n_fams) break;
            long long m0 = fam_first[(size_t)f];
            long long m1 = fam_first[(size_t)f + 1];
            long long maxkey = 0;
            long long nbases = 0;
            for (long long m = m0; m < m1; ++m) {
                long long lo = member_starts[m];
                long long hi = lo + base_counts[m];
                nbases += hi - lo;
                for (long long i = lo; i < hi; ++i) {
                    long long k = ((long long)all_pos[i] << 4)
                                  | (all_mask[i] & 0xF);
                    if (k > maxkey) maxkey = k;
                }
            }
            if ((long long)stamp.size() <= maxkey) {
                stamp.assign((size_t)maxkey + 1, -1);
                id_of.resize((size_t)maxkey + 1);
                epoch = 0;
            }
            ++epoch;
            uniq.clear();
            for (long long m = m0; m < m1; ++m) {
                long long lo = member_starts[m];
                long long hi = lo + base_counts[m];
                for (long long i = lo; i < hi; ++i) {
                    long long k = ((long long)all_pos[i] << 4)
                                  | (all_mask[i] & 0xF);
                    if (stamp[(size_t)k] != epoch) {
                        stamp[(size_t)k] = epoch;
                        uniq.push_back(k);
                    }
                }
            }
            std::sort(uniq.begin(), uniq.end());
            long long n = (long long)uniq.size();
            long long off = node_offsets[f];
            if (off + n > node_offsets[f + 1]) {
                err.store(1);
                return;
            }
            for (long long j = 0; j < n; ++j) {
                id_of[(size_t)uniq[(size_t)j]] = (int)j;
                out_pos[off + j] = (int)(uniq[(size_t)j] >> 4);
                out_mask[off + j] =
                    (unsigned char)(uniq[(size_t)j] & 0xF);
                out_count[off + j] = 0;
                for (long p = 0; p < P; ++p)
                    out_preds[(off + j) * P + p] = -1;
            }
            node_of.resize((size_t)nbases);
            {
                size_t b = 0;
                for (long long m = m0; m < m1; ++m) {
                    long long lo = member_starts[m];
                    long long hi = lo + base_counts[m];
                    for (long long i = lo; i < hi; ++i, ++b) {
                        long long k =
                            ((long long)all_pos[i] << 4)
                            | (all_mask[i] & 0xF);
                        int id = id_of[(size_t)k];
                        node_of[b] = id;
                        ++out_count[off + id];
                    }
                }
            }
            has_succ.assign((size_t)n, 0);
            minnext.assign((size_t)n, INT32_MAX);
            npred.assign((size_t)n, 0);
            {
                size_t base = 0;
                for (long long m = m0; m < m1; ++m) {
                    long long len = base_counts[m];
                    for (long long i = 1; i < len; ++i) {
                        int s = node_of[base + i - 1];
                        int d = node_of[base + i];
                        // ascending unique insert, keep lowest P
                        int* slots = out_preds + (off + d) * P;
                        int& np = npred[(size_t)d];
                        int lim = np < (int)P ? np : (int)P;
                        int q = 0;
                        while (q < lim && slots[q] < s) ++q;
                        if (q < lim && slots[q] == s) {
                            // duplicate edge: nothing new
                        } else {
                            for (int r = (lim < (int)P ? lim
                                                       : (int)P - 1);
                                 r > q; --r)
                                slots[r] = slots[r - 1];
                            if (q < (int)P) slots[q] = s;
                            ++np;
                        }
                        has_succ[(size_t)s] = 1;
                        int dpos = out_pos[off + d];
                        if (dpos < minnext[(size_t)s])
                            minnext[(size_t)s] = dpos;
                    }
                    base += (size_t)len;
                }
            }
            for (long long j = 0; j < n; ++j) {
                int pos_j = out_pos[off + j];
                out_flags[off + j] = (unsigned char)(
                    (npred[(size_t)j] == 0 ? 1 : 0)
                    | (has_succ[(size_t)j] ? 0 : 2));
                out_maxins[off + j] =
                    has_succ[(size_t)j]
                        ? minnext[(size_t)j] - pos_j - 1
                        : 1000000;
            }
            n_nodes_out[f] = n;
        }
    };
    long nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_fams) nt = n_fams > 0 ? n_fams : 1;
    std::vector<std::thread> threads;
    for (long t = 1; t < nt; ++t) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
    return err.load() ? -1 : 0;
}

// Graph-tensor packing for the Pallas graph kernel (the host side of
// ops/graph_pallas.pack_graph_host): predecessor lists (B, N, P)
// collapse to per-node distance bitmasks and the boolean planes fold
// into one flag byte.  Parallel over batch rows.
long sina_pack_graph(
    const int* preds,            // (B, N, P)
    const unsigned char* is_start,   // (B, N)
    const unsigned char* is_end,     // (B, N)
    const long long* n_real,         // (B,)
    long B, long N, long P,
    int* predbits,               // (B, N) out
    unsigned char* flags,        // (B, N) out
    long n_threads) {
    long nt = n_threads > 0 ? n_threads : 1;
    if (nt > B) nt = B > 0 ? B : 1;
    std::atomic<long> next(0);
    auto worker = [&]() {
        for (;;) {
            long b = next.fetch_add(1);
            if (b >= B) break;
            const int* pb = preds + (long long)b * N * P;
            const unsigned char* sb = is_start + (long long)b * N;
            const unsigned char* eb = is_end + (long long)b * N;
            int* ob = predbits + (long long)b * N;
            unsigned char* fb = flags + (long long)b * N;
            long long nr = n_real[b];
            for (long j = 0; j < N; ++j) {
                unsigned int bits = 0;
                const int* row = pb + (long long)j * P;
                for (long p = 0; p < P; ++p) {
                    int pr = row[p];
                    if (pr < 0) continue;
                    long d = j - pr;
                    if (d > 0 && d < 32) bits |= (1u << d);
                }
                ob[j] = (int)bits;
                fb[j] = (unsigned char)(
                    (sb[j] ? 1 : 0) | (eb[j] ? 2 : 0)
                    | ((j < nr) ? 4 : 0));
            }
        }
    };
    std::vector<std::thread> threads;
    for (long t = 1; t < nt; ++t) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
    return 0;
}

// Batched alignment-copy containment (the try_copy_alignment fast
// path, semantics of align.cpp:328-389): for each query and each of
// its family members, find the first offset at which the member's
// case-stripped 4-bit mask sequence contains the query's as a
// contiguous subarray.  Equivalent to the reference's normalized
// base-string test (upper + U->T): the 4-bit IUPAC code already
// strips case and maps U and T to the same mask.  The per-query
// string building + `in` checks cost ~0.6 ms/query of host wall at
// SILVA scale (the r5 100k steady-state "copy path" item).
//
//   flat_mask4/member_starts/member_counts  shared ref store (CSR
//                                           rows per family member)
//   fam_sizes[B]                            members per query
//   qmask4/qoffsets                         concatenated query masks
//   out_off[n_total]                        first match offset or -1
long sina_contains(
    const unsigned char* flat_mask4,
    const long long* member_starts, const long long* member_counts,
    const long long* fam_sizes,
    const unsigned char* qmask4, const long long* qoffsets,
    long B,
    long long* out_off, long n_threads) {
    std::vector<long long> fam_cursor((size_t)B + 1, 0);
    for (long b = 0; b < B; ++b)
        fam_cursor[b + 1] = fam_cursor[b] + fam_sizes[b];
    std::atomic<long> next(0);
    auto worker = [&]() {
        for (;;) {
            long b = next.fetch_add(1);
            if (b >= B) break;
            const unsigned char* q = qmask4 + qoffsets[b];
            size_t qlen = (size_t)(qoffsets[b + 1] - qoffsets[b]);
            for (long long m = fam_cursor[b]; m < fam_cursor[b + 1];
                 ++m) {
                const unsigned char* r = flat_mask4 + member_starts[m];
                size_t rlen = (size_t)member_counts[m];
                if (qlen == 0) { out_off[m] = 0; continue; }
                if (rlen < qlen) { out_off[m] = -1; continue; }
                const void* hit = memmem(r, rlen, q, qlen);
                out_off[m] = hit
                    ? (long long)((const unsigned char*)hit - r)
                    : -1;
            }
        }
    };
    long nt = n_threads < 1 ? 1 : n_threads;
    std::vector<std::thread> threads;
    for (long t = 1; t < nt; ++t) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"
