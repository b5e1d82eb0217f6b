// Native host kernels for the raxtax-tpu data layer.
//
// Native re-ownership of the reference's CPU-side hot paths
// (reference: src/tree.rs:114-137 k-mer map build, src/utils.rs:27-40 k-mer
// extraction): the inverted-index construction becomes a one-pass packed
// bit-matrix build. Every sequence's distinct 8-mers are materialized in a
// 65,536-bit stack bitmap (8 KiB), which doubles as that sequence's
// ref-major presence row; the kmer-major matrix (postings bitvectors) is a
// bit-transpose second pass. No sorting, no COO, no hashing.
//
// Plain C ABI, loaded via ctypes (no pybind11 in this environment).
//
// Encoding contract (matches raxtax_tpu/utils/encoding.py):
//   4-bit one-hot IUPAC codes; A=1, C=2, G=4, T=8 map to 2-bit 0,1,2,3;
//   any other code invalidates the 8-wide window. Packed 8-mer: first base
//   is the high 2 bits (reference: src/utils.rs:33 `c << (14 - j*2)`).

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Run fn(t) on `nthreads` workers (fn(0) inline when nthreads <= 1).
// The reference parallelizes its postings dedup with rayon
// (reference: src/tree.rs:134-137, thread count from -t, src/main.rs:119);
// here the whole bit-matrix build threads the same way.
template <typename F>
inline void parallel_for_threads(int nthreads, F fn) {
    if (nthreads <= 1) {
        fn(0);
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(fn, t);
    for (auto& th : pool) th.join();
}

}  // namespace

namespace {

constexpr int K = 8;
constexpr int NUM_KMERS = 1 << 16;
constexpr int REF_WORDS = NUM_KMERS / 32;  // 2048

// 4-bit one-hot -> 2-bit base code, 255 = ambiguous/invalid
inline const uint8_t* two_bit_lut() {
    static uint8_t lut[16];
    static bool init = false;
    if (!init) {
        memset(lut, 255, sizeof(lut));
        lut[1] = 0;  // A
        lut[2] = 1;  // C
        lut[4] = 2;  // G
        lut[8] = 3;  // T
        init = true;
    }
    return lut;
}

// Set the distinct-8-mer presence bits of one sequence into an
// already-zeroed 2048-word row. Returns nothing; callers can popcount.
inline void fill_presence_row(const uint8_t* seq, int64_t n, uint32_t* row) {
    if (n < K) return;
    const uint8_t* lut = two_bit_lut();
    uint32_t packed = 0;   // rolling 16-bit window
    int valid = 0;         // consecutive valid bases seen
    for (int64_t i = 0; i < n; ++i) {
        uint8_t b = lut[seq[i] & 15];
        if (b == 255) {
            valid = 0;
            continue;
        }
        packed = ((packed << 2) | b) & 0xFFFF;
        if (++valid >= K) {
            row[packed >> 5] |= (uint32_t(1) << (packed & 31));
        }
    }
}

}  // namespace

extern "C" {

// Build the ref-major presence matrix [n_seqs, 2048] u32 (zeroed by caller)
// and per-sequence distinct-kmer counts. Rows are independent, so threads
// split the sequence range evenly.
void rx_build_ref_major(const uint8_t* flat, const int64_t* offsets,
                        int64_t n_seqs, uint32_t* ref_major,
                        int32_t* kmer_counts, int32_t nthreads) {
    parallel_for_threads(std::max(1, (int)nthreads), [&](int t) {
        int nt = std::max(1, (int)nthreads);
        int64_t lo = n_seqs * t / nt, hi = n_seqs * (t + 1) / nt;
        for (int64_t s = lo; s < hi; ++s) {
            uint32_t* row = ref_major + s * REF_WORDS;
            fill_presence_row(flat + offsets[s], offsets[s + 1] - offsets[s],
                              row);
            int32_t cnt = 0;
            for (int w = 0; w < REF_WORDS; ++w)
                cnt += __builtin_popcount(row[w]);
            kmer_counts[s] = cnt;
        }
    });
}

// Bit-transpose machinery for the kmer-major postings matrix
// [NUM_KMERS + 1, nw] u32 (zeroed by caller; row 65536 stays zero as the
// padding row). Bit n of row k = reference n contains kmer k.
//
// A direct scatter (for each set bit: kmer_major[k*nw + s/32] |= bit) is
// TLB/cache-hostile at scale: every write lands at a ~4*nw-byte stride in a
// multi-GB destination (measured 430+ s for 1M references on one core).
// And on this class of VM, FRESH memory is brutally expensive (host-side
// provisioning at tens of MB/s), so big one-shot COO side arrays cost more
// in page faults than their scatter saves. Hence: process references in
// CHUNKS, appending each chunk's set bits into 1024 reusable per-bucket
// vectors ((kmer << 32) | seq entries; vectors keep their capacity across
// chunks, so the fault cost is paid once for ~400 MB), then scatter each
// bucket into its 64-row output tile (64 * 4*nw bytes = 8 MiB at 1M refs —
// cache resident). Threads split the bucket range in the scatter (disjoint
// output tiles).

namespace {

constexpr int BUCKET_KMERS = 64;
constexpr int N_BUCKETS = NUM_KMERS / BUCKET_KMERS;  // 1024
constexpr int64_t TRANSPOSE_CHUNK = 131072;

// Append every set bit of `row` (one reference's presence bitmap) as
// (kmer << 32) | s into its k-mer bucket.
inline void bucket_row_bits(const uint32_t* row, int64_t s,
                            std::vector<uint64_t>* buckets) {
    for (int w = 0; w < REF_WORDS; ++w) {
        uint32_t v = row[w];
        while (v) {
            int bit = __builtin_ctz(v);
            v &= v - 1;
            uint64_t k = (uint64_t)(w * 32 + bit);
            buckets[k / BUCKET_KMERS].push_back((k << 32) | (uint64_t)s);
        }
    }
}

// Scatter the bucketed entries of one chunk into the output matrix;
// threads own disjoint bucket ranges (disjoint output rows).
inline void scatter_buckets(std::vector<uint64_t>* buckets,
                            uint32_t* kmer_major, int64_t nw, int nt) {
    parallel_for_threads(nt, [&](int t) {
        int blo = N_BUCKETS * t / nt, bhi = N_BUCKETS * (t + 1) / nt;
        for (int b = blo; b < bhi; ++b) {
            for (uint64_t e : buckets[b]) {
                uint32_t s = (uint32_t)e;
                kmer_major[(e >> 32) * nw + (s >> 5)] |=
                    uint32_t(1) << (s & 31);
            }
            buckets[b].clear();
        }
    });
}

}  // namespace

// `flat_w` selects the reference-column layout: 0 keeps the packed order
// (ref r -> word r/32, bit r%32); a positive value W lays references out
// FLAT (ref r -> word r%W, bit r/W, nw must equal W), so that the fold
// kernel's bit-major expansion enumerates references in taxonomy order —
// the device then needs no [B, n] permute before the prefix scan.
static inline int64_t ref_col(int64_t s, int64_t flat_w) {
    return flat_w ? (s % flat_w) * 32 + s / flat_w : s;
}

void rx_build_kmer_major(const uint32_t* ref_major, int64_t n_seqs,
                         uint32_t* kmer_major, int64_t nw, int32_t nthreads,
                         int64_t flat_w) {
    const int nt = std::max(1, (int)nthreads);
    std::vector<std::vector<uint64_t>> buckets(N_BUCKETS);
    for (int64_t base = 0; base < n_seqs; base += TRANSPOSE_CHUNK) {
        int64_t hi = std::min(base + TRANSPOSE_CHUNK, n_seqs);
        for (int64_t s = base; s < hi; ++s)
            bucket_row_bits(ref_major + s * REF_WORDS, ref_col(s, flat_w),
                            buckets.data());
        scatter_buckets(buckets.data(), kmer_major, nw, nt);
    }
}

// Direct variant: builds the postings matrix straight from the encoded
// sequences without materializing the 8 GB ref-major intermediate (the
// Pallas/stream backends and the host oracle never read ref-major, so a
// 1M-reference database build touches ~9 GB of fresh memory instead of
// ~20 GB). Each sequence's presence bitmap lives in a reused 8 KiB buffer.
void rx_build_kmer_major_direct(const uint8_t* flat, const int64_t* offsets,
                                int64_t n_seqs, uint32_t* kmer_major,
                                int64_t nw, int32_t nthreads,
                                int64_t flat_w) {
    const int nt = std::max(1, (int)nthreads);
    std::vector<std::vector<uint64_t>> buckets(N_BUCKETS);
    std::vector<uint32_t> row(REF_WORDS);
    for (int64_t base = 0; base < n_seqs; base += TRANSPOSE_CHUNK) {
        int64_t hi = std::min(base + TRANSPOSE_CHUNK, n_seqs);
        for (int64_t s = base; s < hi; ++s) {
            memset(row.data(), 0, REF_WORDS * sizeof(uint32_t));
            fill_presence_row(flat + offsets[s], offsets[s + 1] - offsets[s],
                              row.data());
            bucket_row_bits(row.data(), ref_col(s, flat_w), buckets.data());
        }
        scatter_buckets(buckets.data(), kmer_major, nw, nt);
    }
}

// Sorted distinct 8-mers of one sequence (bitmap scan => sorted for free).
// `out` must hold up to 65,536 entries; returns the count.
int64_t rx_distinct_kmers(const uint8_t* seq, int64_t n, uint16_t* out) {
    uint32_t row[REF_WORDS];
    memset(row, 0, sizeof(row));
    fill_presence_row(seq, n, row);
    int64_t m = 0;
    for (int w = 0; w < REF_WORDS; ++w) {
        uint32_t v = row[w];
        while (v) {
            int b = __builtin_ctz(v);
            v &= v - 1;
            out[m++] = uint16_t(w * 32 + b);
        }
    }
    return m;
}

// Batch variant: flat/offsets in, per-sequence sorted distinct kmers packed
// into `out` with `out_offsets` (caller sizes `out` at total windows bound
// or 65,536 per sequence; we write cumulative offsets).
void rx_distinct_kmers_batch(const uint8_t* flat, const int64_t* offsets,
                             int64_t n_seqs, uint16_t* out,
                             int64_t* out_offsets) {
    int64_t pos = 0;
    out_offsets[0] = 0;
    for (int64_t s = 0; s < n_seqs; ++s) {
        pos += rx_distinct_kmers(flat + offsets[s],
                                 offsets[s + 1] - offsets[s], out + pos);
        out_offsets[s + 1] = pos;
    }
}

// FNV-1a 64 hash of every sequence (exact-match index; this build's
// replacement for the reference's HashMap keys, src/tree.rs:50-51). The
// trailing length mix keeps prefix collisions apart. Threads split the
// sequence range.
void rx_hash_sequences(const uint8_t* flat, const int64_t* offsets,
                       int64_t n_seqs, uint64_t* out, int32_t nthreads) {
    parallel_for_threads(std::max(1, (int)nthreads), [&](int t) {
        int nt = std::max(1, (int)nthreads);
        int64_t lo = n_seqs * t / nt, hi = n_seqs * (t + 1) / nt;
        for (int64_t s = lo; s < hi; ++s) {
            uint64_t h = 1469598103934665603ull;  // FNV offset basis
            for (int64_t i = offsets[s]; i < offsets[s + 1]; ++i) {
                h ^= flat[i];
                h *= 1099511628211ull;  // FNV prime
            }
            h ^= (uint64_t)(offsets[s + 1] - offsets[s]);
            h *= 1099511628211ull;
            out[s] = h;
        }
    });
}

// Query presence rows: [n_seqs, 2048] u32 (zeroed by caller), one row per
// query sequence — the host side of pack_query_kmers.
void rx_pack_query_rows(const uint8_t* flat, const int64_t* offsets,
                        int64_t n_seqs, uint32_t* rows) {
    for (int64_t s = 0; s < n_seqs; ++s) {
        fill_presence_row(flat + offsets[s], offsets[s + 1] - offsets[s],
                          rows + s * REF_WORDS);
    }
}

}  // extern "C"

// FASTA parsing + 4-bit IUPAC encoding in one pass
// (reference: src/parser.rs:36-154). Lines are trimmed; blank and ';'
// comment lines dropped; reference mode extracts the lineage via the
// `tax=([^;]+);` pattern (first position where "tax=" is followed by at
// least one non-';' char and a terminating ';'), query mode takes the full
// header. Query-mode consecutive headers collapse onto the last one (the
// running sequence is only flushed when non-empty, src/parser.rs:138-141).
//
// Returns 0 on success; 1 bad char, 2 missing tax=, 3 not-FASTA,
// 4 label/sequence count mismatch. Callers re-run the (slow) Python parser
// on error to produce the reference's exact error messages.

namespace {

inline const uint8_t* iupac_lut() {
    static uint8_t lut[256];
    static bool init = false;
    if (!init) {
        memset(lut, 0xFF, sizeof(lut));
        auto set = [&](char c, uint8_t v) {
            lut[(uint8_t)c] = v;
            lut[(uint8_t)(c | 32)] = v;  // lowercase
        };
        set('A', 1); set('C', 2); set('G', 4); set('T', 8);
        set('W', 1 | 8); set('S', 2 | 4); set('M', 1 | 2); set('K', 4 | 8);
        set('R', 1 | 4); set('Y', 2 | 8);
        set('B', 2 | 4 | 8); set('D', 1 | 4 | 8); set('H', 1 | 2 | 8);
        set('V', 1 | 2 | 4); set('N', 1 | 2 | 4 | 8);
        init = true;
    }
    return lut;
}

}  // namespace

extern "C" {

int rx_parse_fasta(const uint8_t* text, int64_t n, int with_tax,
                   uint8_t* seq_out, int64_t* seq_offsets,
                   int64_t* label_ranges, int64_t* n_records_out) {
    const uint8_t* lut = iupac_lut();
    int64_t n_labels = 0, n_chunks = 0, seq_pos = 0;
    int64_t chunk_start = 0;  // seq_pos at the start of the running chunk
    bool seen_any = false;
    bool have_label = false;  // query mode: a header was seen
    seq_offsets[0] = 0;
    int64_t i = 0;
    while (i < n) {
        // one line [i, j)
        int64_t j = i;
        while (j < n && text[j] != '\n') ++j;
        int64_t a = i, b = j;
        while (a < b && (unsigned char)text[a] <= ' ') ++a;   // ltrim
        while (b > a && (unsigned char)text[b - 1] <= ' ') --b;  // rtrim
        i = j + 1;
        if (a == b || text[a] == ';') continue;  // blank / comment
        if (!seen_any && text[a] != '>') return 3;
        seen_any = true;
        if (text[a] == '>') {
            int64_t ls = a + 1, le = b;
            if (with_tax) {
                // tax=([^;]+); search
                int64_t ts = -1, te = -1;
                for (int64_t p = ls; p + 5 <= le; ++p) {
                    if (text[p] == 't' && text[p + 1] == 'a' &&
                        text[p + 2] == 'x' && text[p + 3] == '=') {
                        int64_t q = p + 4;
                        while (q < le && text[q] != ';') ++q;
                        if (q < le && q > p + 4) { ts = p + 4; te = q; break; }
                    }
                }
                if (ts < 0) return 2;
                label_ranges[2 * n_labels] = ts;
                label_ranges[2 * n_labels + 1] = te;
                ++n_labels;
                if (seq_pos > chunk_start) {  // flush non-empty chunk
                    seq_offsets[++n_chunks] = seq_pos;
                    chunk_start = seq_pos;
                }
            } else {
                if (have_label && seq_pos > chunk_start) {
                    seq_offsets[++n_chunks] = seq_pos;
                    chunk_start = seq_pos;
                    ++n_labels;  // previous label committed
                }
                label_ranges[2 * n_labels] = ls;
                label_ranges[2 * n_labels + 1] = le;
                have_label = true;
            }
        } else {
            for (int64_t p = a; p < b; ++p) {
                uint8_t v = lut[text[p]];
                if (v == 0xFF) return 1;
                seq_out[seq_pos++] = v;
            }
        }
    }
    // final chunk: always appended (src/parser.rs:82, 144)
    seq_offsets[++n_chunks] = seq_pos;
    chunk_start = seq_pos;
    if (with_tax) {
        if (n_labels != n_chunks) return 4;
    } else {
        if (have_label) ++n_labels;
        n_chunks = n_labels;  // query mode: one chunk per committed label
    }
    *n_records_out = n_labels;
    return 0;
}

// Sequential f64 tip-probability prefix sum from a compressed count row
// (4-bit nibble plane + ascending (tip, count) overflow list): the exact
// host replay of the reference's per-query prefix scan
// (reference: src/lineage.rs:62-67) that the fallback descent compares
// against. Fuses nibble decode + table gather + running sum in one pass —
// the numpy equivalent materializes several N-sized intermediates and is
// ~15x slower on a single-core host.
//
// `cum` has num_tips + 1 entries; cum[0] = 0. Left-to-right f64 additions,
// identical rounding to the reference's sequential scan.
void rx_tip_cumsum_nibble(const uint32_t* plane, const int32_t* over_idx,
                          const uint16_t* over_val, int64_t n_over,
                          const double* table, int64_t num_tips,
                          double* cum) {
    double acc = 0.0;
    cum[0] = 0.0;
    int64_t oi = 0;
    for (int64_t i = 0; i < num_tips; ++i) {
        uint32_t c = (plane[i >> 3] >> ((i & 7) * 4)) & 15u;
        if (oi < n_over && over_idx[oi] == i) {
            c = over_val[oi];
            ++oi;
        }
        acc += table[c];
        cum[i + 1] = acc;
    }
}

// Same, from the planes wire format: four bit-sliced tier planes (the raw
// Harley-Seal ones/twos/fours/eights counters, so the device ships them
// with ZERO repacking work) plus the ascending overflow list for counts
// > 15. Tip i lives in word i>>5, bit i&31 of each plane.
// `flat_w` selects the tip layout (see rx_build_kmer_major): 0 = packed
// (tip i -> word i/32, bit i%32); W = flat (tip q -> word q%W, bit q/W).
void rx_tip_cumsum_planes4(const uint32_t* p0, int64_t plane_words,
                           const int32_t* over_idx, const uint16_t* over_val,
                           int64_t n_over, const double* table,
                           int64_t num_tips, double* cum, int64_t flat_w) {
    const uint32_t* p1 = p0 + plane_words;
    const uint32_t* p2 = p1 + plane_words;
    const uint32_t* p3 = p2 + plane_words;
    double acc = 0.0;
    cum[0] = 0.0;
    int64_t oi = 0;
    if (flat_w) {
        // flat layout: sequential q walks each bit layer's words in order
        int64_t q = 0;
        for (int64_t b = 0; q < num_tips; ++b) {
            uint32_t m0 = uint32_t(1) << (b & 31);
            for (int64_t w = 0; w < flat_w && q < num_tips; ++w, ++q) {
                uint32_t c = ((p0[w] & m0) ? 1u : 0u) |
                             ((p1[w] & m0) ? 2u : 0u) |
                             ((p2[w] & m0) ? 4u : 0u) |
                             ((p3[w] & m0) ? 8u : 0u);
                if (oi < n_over && over_idx[oi] == q) {
                    c = over_val[oi];
                    ++oi;
                }
                acc += table[c];
                cum[q + 1] = acc;
            }
        }
        return;
    }
    for (int64_t w = 0; w * 32 < num_tips; ++w) {
        uint32_t b0 = p0[w], b1 = p1[w], b2 = p2[w], b3 = p3[w];
        int64_t base = w * 32;
        int64_t hi = num_tips - base < 32 ? num_tips - base : 32;
        for (int64_t j = 0; j < hi; ++j) {
            uint32_t c = ((b0 >> j) & 1u) | (((b1 >> j) & 1u) << 1) |
                         (((b2 >> j) & 1u) << 2) | (((b3 >> j) & 1u) << 3);
            int64_t i = base + j;
            if (oi < n_over && over_idx[oi] == i) {
                c = over_val[oi];
                ++oi;
            }
            acc += table[c];
            cum[i + 1] = acc;
        }
    }
}

// Same, from a raw u16 count row (over-budget fallback path).
void rx_tip_cumsum_u16(const uint16_t* row, const double* table,
                       int64_t num_tips, double* cum) {
    double acc = 0.0;
    cum[0] = 0.0;
    for (int64_t i = 0; i < num_tips; ++i) {
        acc += table[row[i]];
        cum[i + 1] = acc;
    }
}

// Batched max-confidence fallback descents (src/lineage.rs:151-177), all
// on host in one call. For each unique wire row referenced by the
// query-grouped site list, the exact sequential-f64 tip prefix sum is
// built ONCE from the planes wire (identical rounding to
// rx_tip_cumsum_planes4), then every site of that row descends into the
// max-confidence child while the node is Inner, keeping the LAST maximal
// child on ties (Rust max_by). Replaces, on tie-dense workloads, a
// device descent + 2 device->host pulls + per-query ctypes replay calls with
// one bounded host pass.
void rx_descend_planes4_batch(
    const uint32_t* lo4, int64_t plane_words,   // [n_rows, 4, plane_words]
    const int32_t* over_idx,                    // [n_rows, budget]
    const uint16_t* over_val,                   // [n_rows, budget]
    int64_t budget, const int64_t* n_over,      // [n_rows]
    const double* tables, const int64_t* table_off,  // per-row f64 tables
    int64_t num_tips,
    const int32_t* site_row, const int32_t* site_node, int64_t n_sites,
    const int32_t* range_start, const int32_t* range_end,
    const int32_t* child_ptr, const int32_t* child_ids,
    const uint8_t* node_type,
    int32_t* out_final, int64_t flat_w) {
    double* cum = (double*)malloc((size_t)(num_tips + 1) * sizeof(double));
    if (!cum) { for (int64_t i = 0; i < n_sites; ++i) out_final[i] = -1; return; }
    int64_t cur_row = -1;
    for (int64_t i = 0; i < n_sites; ++i) {
        int64_t r = site_row[i];
        if (r != cur_row) {
            rx_tip_cumsum_planes4(
                lo4 + r * 4 * plane_words, plane_words,
                over_idx + r * budget, over_val + r * budget, n_over[r],
                tables + table_off[r], num_tips, cum, flat_w);
            cur_row = r;
        }
        int32_t node = site_node[i];
        while (node_type[node] == 0 /* NODE_INNER */) {
            int32_t lo = child_ptr[node], hi = child_ptr[node + 1];
            double best = -1.0;
            int32_t best_id = node;
            for (int32_t c = lo; c < hi; ++c) {
                int32_t cid = child_ids[c];
                double v = cum[range_end[cid]] - cum[range_start[cid]];
                if (v >= best) { best = v; best_id = cid; }
            }
            node = best_id;
        }
        out_final[i] = node;
    }
    free(cum);
}

}  // extern "C"

// ---------------------------------------------------------------------
// Native per-query lineage evaluation + formatting.
//
// Replay of the reference's eval_recurse over the significant-node sparse
// set (reference: src/lineage.rs:119-179) plus result formatting
// (src/lineage.rs:17-48, src/utils.rs:62-105), in C++: the Python replay
// costs ~0.8 ms per query on fallback-dense workloads (dozens of emitted
// lines), which caps end-to-end throughput once the device stages are
// fast. Semantics preserved exactly:
//   - child confidences rounded half-away-from-zero at 2 decimals before
//     the zero-pruning test; emission at Taxon nodes that pushed nothing;
//   - fallback at Inner nodes with no significant child: follow the
//     precomputed max-confidence leaf at 0.01 per descended level;
//   - results sorted descending-lexicographically, stable ties;
//   - local_signal = L2 distance of sum-normalized observed vs expected
//     vectors from the first level where expected < 1.0 (sequential
//     left-to-right f64 sums, like Rust's Iterator::sum);
//   - %.2f / %.5f fixed formatting (correctly rounded, same as Rust/Python).

#include <cmath>
#include <cstdio>
#include <string>
#include <vector>
#include <algorithm>
#include <functional>

namespace {

constexpr uint8_t NODE_INNER = 0;
constexpr uint8_t NODE_TAXON = 1;

inline double round2_away(double v) {
    return std::copysign(std::floor(std::fabs(v * 100.0) + 0.5), v) / 100.0;
}

struct EvalResult {
    int32_t tip;
    std::vector<double> conf;
    std::vector<double> expected;
    double local = 0.0;
};

// 4-bit one-hot code -> display char ('-' for ambiguity codes), matching
// decompress_sequence (reference: src/utils.rs:70-81).
inline const char* decomp_lut() {
    static char lut[16];
    static bool init = false;
    if (!init) {
        memset(lut, '-', sizeof(lut));
        lut[1] = 'A'; lut[2] = 'C'; lut[4] = 'G'; lut[8] = 'T';
        init = true;
    }
    return lut;
}

// One query's evaluation-recursion replay + formatting, appending to
// `out`/`tsv` (reference: src/lineage.rs:119-179, 17-48). Returns
// 0 ok, 2 no results, 3 missing fallback entry (caller replays in Python).
// `sig` entries need NOT be pre-sorted; sorted ascending by node here.
int eval_core(
    const int32_t* parent, const uint8_t* node_type,
    const int32_t* range_start, const int32_t* range_end, int64_t num_tips,
    const char* lineage_blob, const int64_t* lineage_offsets,
    const char* label, int64_t label_len,
    const int32_t* sig_nodes, const double* sig_vals, int64_t n_sig,
    const int32_t* fb_starts, const int32_t* fb_leaves, int64_t n_fb,
    double global_signal, int32_t override_tip, int32_t want_tsv,
    const char* seq_str, int64_t seq_len,
    std::string& out, std::string& tsv) {
    struct SigChild { int32_t parent, child; double rounded; };
    std::vector<SigChild> entries;
    entries.reserve(n_sig);
    for (int64_t i = 0; i < n_sig; ++i) {
        double r = round2_away(sig_vals[i]);
        if (r == 0.0 || sig_nodes[i] == 0) continue;
        entries.push_back({parent[sig_nodes[i]], sig_nodes[i], r});
    }
    // ascending (parent, child): children of each node in id (creation)
    // order, the reference's recursion order (src/lineage.rs:119-127)
    std::sort(entries.begin(), entries.end(),
              [](const SigChild& a, const SigChild& b) {
                  return a.parent != b.parent ? a.parent < b.parent
                                              : a.child < b.child;
              });

    auto children_of = [&](int32_t node, int64_t& lo, int64_t& hi) {
        SigChild key{node, 0, 0.0};
        auto a = std::lower_bound(
            entries.begin(), entries.end(), key,
            [](const SigChild& x, const SigChild& y) { return x.parent < y.parent; });
        auto b = std::upper_bound(
            entries.begin(), entries.end(), key,
            [](const SigChild& x, const SigChild& y) { return x.parent < y.parent; });
        lo = a - entries.begin();
        hi = b - entries.begin();
    };

    const double inv_tips = 1.0 / double(num_tips);
    auto frac = [&](int32_t n) {
        return double(range_end[n] - range_start[n]) * inv_tips;
    };

    std::vector<EvalResult> results;
    std::vector<double> conf_prefix, exp_prefix;
    bool missing_fallback = false;

    // iterative replay of the recursion; returns whether the subtree
    // pushed a result ("child_pushed" of the reference)
    std::function<bool(int32_t)> recurse = [&](int32_t node) -> bool {
        int64_t lo, hi;
        children_of(node, lo, hi);
        bool pushed = false;
        bool no_child = (lo == hi);
        for (int64_t i = lo; i < hi; ++i) {
            int32_t c = entries[i].child;
            conf_prefix.push_back(entries[i].rounded);
            exp_prefix.push_back(frac(c));
            bool child_pushed = recurse(c);
            if (!child_pushed && node_type[c] == NODE_TAXON) {
                results.push_back(
                    {range_start[c], conf_prefix, exp_prefix, 0.0});
                pushed = true;
            }
            pushed |= child_pushed;
            conf_prefix.pop_back();
            exp_prefix.pop_back();
        }
        if (no_child && node_type[node] == NODE_INNER) {
            // fallback: precomputed max-confidence leaf for this start node
            int32_t leaf = -1;
            for (int64_t i = 0; i < n_fb; ++i)
                if (fb_starts[i] == node) { leaf = fb_leaves[i]; break; }
            if (leaf < 0) missing_fallback = true;
            if (leaf >= 0) {
                // path strictly below `node` down to `leaf`
                std::vector<int32_t> path;
                for (int32_t cur = leaf; cur != node; cur = parent[cur])
                    path.push_back(cur);
                std::reverse(path.begin(), path.end());
                size_t base_c = conf_prefix.size();
                for (int32_t p : path) {
                    conf_prefix.push_back(0.01);
                    exp_prefix.push_back(frac(p));
                }
                results.push_back(
                    {range_start[leaf], conf_prefix, exp_prefix, 0.0});
                conf_prefix.resize(base_c);
                exp_prefix.resize(base_c);
                pushed = true;
            }
        }
        return pushed;
    };
    recurse(0);
    if (missing_fallback) return 3;  // caller re-runs the Python replay

    // descending lexicographic, stable
    std::stable_sort(results.begin(), results.end(),
                     [](const EvalResult& a, const EvalResult& b) {
                         return std::lexicographical_compare(
                             b.conf.begin(), b.conf.end(),
                             a.conf.begin(), a.conf.end());
                     });

    for (auto& r : results) {
        size_t start = r.expected.empty() ? 0 : r.expected.size() - 1;
        for (size_t i = 0; i < r.expected.size(); ++i)
            if (r.expected[i] < 1.0) { start = i; break; }
        double a_sum = 0.0, b_sum = 0.0;
        for (size_t i = start; i < r.conf.size(); ++i) a_sum += r.conf[i];
        for (size_t i = start; i < r.expected.size(); ++i)
            b_sum += r.expected[i];
        double acc = 0.0;
        if (r.conf.size() > start) {
            for (size_t i = start; i < r.conf.size(); ++i) {
                double d = r.conf[i] / a_sum - r.expected[i] / b_sum;
                acc += d * d;
            }
        }
        r.local = std::sqrt(acc);
    }

    // single-exact-match confidence override (src/raxtax.rs:73-84): one
    // line, match's lineage, 1.00 per level, signals from the top result
    char num[64];
    auto lineage_of = [&](int32_t tip, const char** s, int64_t* n) {
        *s = lineage_blob + lineage_offsets[tip];
        *n = lineage_offsets[tip + 1] - lineage_offsets[tip];
    };
    auto emit = [&](int32_t tip, const std::vector<double>& conf,
                    double local) {
        const char* lin; int64_t lin_n;
        lineage_of(tip, &lin, &lin_n);
        out.append(label, label_len);
        out.push_back('\t');
        out.append(lin, lin_n);
        out.push_back('\t');
        for (size_t i = 0; i < conf.size(); ++i) {
            if (i) out.push_back(',');
            snprintf(num, sizeof num, "%.2f", conf[i]);
            out.append(num);
        }
        snprintf(num, sizeof num, "\t%.5f", local);
        out.append(num);
        snprintf(num, sizeof num, "\t%.5f", global_signal);
        out.append(num);
        out.push_back('\n');
        if (want_tsv) {
            tsv.append(label, label_len);
            // taxa interleaved with confidences (zip semantics: stop at
            // the shorter of taxa/conf)
            int64_t p = 0; size_t ci = 0;
            while (p < lin_n && ci < conf.size()) {
                int64_t q = p;
                while (q < lin_n && lin[q] != ',') ++q;
                tsv.push_back('\t');
                tsv.append(lin + p, q - p);
                snprintf(num, sizeof num, "\t%.2f", conf[ci]);
                tsv.append(num);
                ++ci;
                p = q + 1;
                if (q == lin_n) break;
            }
            snprintf(num, sizeof num, "\t%.5f", local);
            tsv.append(num);
            snprintf(num, sizeof num, "\t%.5f", global_signal);
            tsv.append(num);
            tsv.push_back('\t');
            tsv.append(seq_str, seq_len);
            tsv.push_back('\n');
        }
    };

    if (override_tip >= 0 && !results.empty()) {
        const char* lin; int64_t lin_n;
        lineage_of(override_tip, &lin, &lin_n);
        int levels = 1;
        for (int64_t i = 0; i < lin_n; ++i)
            if (lin[i] == ',') ++levels;
        std::vector<double> ones(levels, 1.0);
        emit(override_tip, ones, results[0].local);
    } else {
        for (auto& r : results) emit(r.tip, r.conf, r.local);
    }
    if (!out.empty()) out.pop_back();  // join semantics: no trailing \n
    if (want_tsv && !tsv.empty()) tsv.pop_back();
    return results.empty() ? 2 : 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if a buffer was too small (caller retries with
// bigger buffers; *out_len/*tsv_len then hold the required sizes).
int rx_evaluate(
    const int32_t* parent, const uint8_t* node_type,
    const int32_t* range_start, const int32_t* range_end, int64_t num_tips,
    const char* lineage_blob, const int64_t* lineage_offsets,
    const char* label, int64_t label_len,
    const int32_t* sig_nodes, const double* sig_vals, int64_t n_sig,
    const int32_t* fb_starts, const int32_t* fb_leaves, int64_t n_fb,
    double global_signal, int32_t override_tip, int32_t want_tsv,
    const char* seq_str, int64_t seq_len,
    char* out_buf, int64_t out_cap, int64_t* out_len,
    char* tsv_buf, int64_t tsv_cap, int64_t* tsv_len) {
    std::string out, tsv;
    int rc = eval_core(
        parent, node_type, range_start, range_end, num_tips,
        lineage_blob, lineage_offsets, label, label_len,
        sig_nodes, sig_vals, n_sig, fb_starts, fb_leaves, n_fb,
        global_signal, override_tip, want_tsv, seq_str, seq_len, out, tsv);
    if (rc == 3) return 3;
    *out_len = (int64_t)out.size();
    *tsv_len = (int64_t)tsv.size();
    if ((int64_t)out.size() > out_cap || (int64_t)tsv.size() > tsv_cap)
        return 1;
    memcpy(out_buf, out.data(), out.size());
    if (want_tsv) memcpy(tsv_buf, tsv.data(), tsv.size());
    return rc;
}

// Whole-batch evaluation: per-query CSR slices of the packed significant
// set, fallback pairs, labels and RAW 4-bit sequences (decompressed here
// for the tsv path — the reference decodes per emitted line,
// src/lineage.rs:44 / src/utils.rs:70-81). One call replaces B ctypes
// round-trips (the finalize-phase hot spot at large batches).
//
// status[q]: 0 ok, 2 no results, 3 missing fallback (slices empty; caller
// replays that query in Python). Returns 0, or 1 when a buffer was too small
// (out_offsets[n]/tsv_offsets[n] then hold required sizes; retry).
int rx_evaluate_batch(
    const int32_t* parent, const uint8_t* node_type,
    const int32_t* range_start, const int32_t* range_end, int64_t num_tips,
    const char* lineage_blob, const int64_t* lineage_offsets,
    const char* labels_blob, const int64_t* label_offsets,
    const int32_t* sig_nodes, const double* sig_vals,
    const int64_t* sig_offsets,
    const int32_t* fb_starts, const int32_t* fb_leaves,
    const int64_t* fb_offsets,
    const double* global_signals, const int32_t* override_tips,
    int32_t want_tsv,
    const uint8_t* seq4_blob, const int64_t* seq_offsets,
    int64_t n_queries,
    char* out_buf, int64_t out_cap, int64_t* out_offsets,
    char* tsv_buf, int64_t tsv_cap, int64_t* tsv_offsets,
    int32_t* status) {
    std::string out_all, tsv_all, out, tsv, seq_txt;
    const char* lut = decomp_lut();
    out_offsets[0] = 0;
    tsv_offsets[0] = 0;
    for (int64_t q = 0; q < n_queries; ++q) {
        out.clear();
        tsv.clear();
        seq_txt.clear();
        if (want_tsv) {
            seq_txt.reserve(seq_offsets[q + 1] - seq_offsets[q]);
            for (int64_t i = seq_offsets[q]; i < seq_offsets[q + 1]; ++i)
                seq_txt.push_back(lut[seq4_blob[i] & 15]);
        }
        int rc = eval_core(
            parent, node_type, range_start, range_end, num_tips,
            lineage_blob, lineage_offsets,
            labels_blob + label_offsets[q],
            label_offsets[q + 1] - label_offsets[q],
            sig_nodes + sig_offsets[q], sig_vals + sig_offsets[q],
            sig_offsets[q + 1] - sig_offsets[q],
            fb_starts + fb_offsets[q], fb_leaves + fb_offsets[q],
            fb_offsets[q + 1] - fb_offsets[q],
            global_signals[q], override_tips[q], want_tsv,
            seq_txt.data(), (int64_t)seq_txt.size(), out, tsv);
        status[q] = rc;
        if (rc == 0) {
            out_all.append(out);
            if (want_tsv) tsv_all.append(tsv);
        }
        out_offsets[q + 1] = (int64_t)out_all.size();
        tsv_offsets[q + 1] = (int64_t)tsv_all.size();
    }
    if ((int64_t)out_all.size() > out_cap ||
        (int64_t)tsv_all.size() > tsv_cap)
        return 1;
    memcpy(out_buf, out_all.data(), out_all.size());
    if (want_tsv) memcpy(tsv_buf, tsv_all.data(), tsv_all.size());
    return 0;
}

// Fallback-site detection over the packed significant set (the per-query
// Python set/dict pass this replaces was ~tens of ms per 128-query batch).
// Mirrors engine/device.py finalize_batch semantics exactly:
//   rounded_sig = {n : round2(val) != 0, n != root(0)}
//   sites(q)    = {n in rounded_sig ∪ {0} : Inner(n),
//                  n not parent of any rounded_sig node}
// Emits (query, GLOBAL node) pairs. Returns the count, or -(needed) when
// `cap` is too small (caller grows and retries).
int64_t rx_find_sites(
    const int32_t* nodes, const double* vals, const int64_t* offsets,
    int64_t n_queries, const int32_t* parent, const uint8_t* node_type,
    int32_t* out_q, int32_t* out_node, int64_t cap) {
    int64_t n_out = 0;
    std::vector<int32_t> sig, parents;
    for (int64_t q = 0; q < n_queries; ++q) {
        sig.clear();
        parents.clear();
        for (int64_t i = offsets[q]; i < offsets[q + 1]; ++i) {
            if (nodes[i] != 0 && round2_away(vals[i]) != 0.0)
                sig.push_back(nodes[i]);
        }
        parents.reserve(sig.size());
        for (int32_t n : sig) parents.push_back(parent[n]);
        std::sort(parents.begin(), parents.end());
        sig.push_back(0);  // the root is always a candidate
        for (int32_t n : sig) {
            if (node_type[n] != NODE_INNER) continue;
            if (std::binary_search(parents.begin(), parents.end(), n))
                continue;
            if (n_out < cap) {
                out_q[n_out] = (int32_t)q;
                out_node[n_out] = n;
            }
            ++n_out;
        }
    }
    return n_out <= cap ? n_out : -n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Benchmark baseline: the reference's CPU hot loop, re-created natively.
//
// This is NOT part of the classification pipeline — it exists so bench
// tooling can measure what the reference's architecture (inverted-index
// scatter-add, reference: src/raxtax.rs:38, 54-64 + histogramming,
// src/prob.rs:13-19) costs per query on THIS host's CPU, giving an honest
// per-core native baseline to extrapolate multi-core CPU throughput from
// (the Rust toolchain is unavailable in this environment; see
// scripts/native_baseline.py).

extern "C" {

// Scatter-add intersection counts + size histogram for one query.
//   postings/offsets: CSR inverted index, offsets[65537]
//   kmers[n_kmers]:   the query's sorted distinct 8-mers
//   buffer[num_tips]: scratch, zeroed here (reference: src/raxtax.rs:41)
//   hist[n_kmers+1]:  output histogram of intersection sizes
// Returns the number of postings traversed (the loop's work measure).
int64_t rx_baseline_intersect(
    const int32_t* postings, const int64_t* offsets,
    const uint16_t* kmers, int64_t n_kmers,
    uint16_t* buffer, int64_t num_tips,
    int64_t* hist) {
    memset(buffer, 0, (size_t)num_tips * sizeof(uint16_t));
    int64_t work = 0;
    for (int64_t i = 0; i < n_kmers; ++i) {
        const int64_t lo = offsets[kmers[i]], hi = offsets[kmers[i] + 1];
        for (int64_t p = lo; p < hi; ++p) buffer[postings[p]]++;
        work += hi - lo;
    }
    memset(hist, 0, (size_t)(n_kmers + 1) * sizeof(int64_t));
    for (int64_t n = 0; n < num_tips; ++n) hist[buffer[n]]++;
    return work;
}
}  // extern "C"
