// Native host codec for wavelet_tpu: threaded threshold+RLE+serialize+xz.
//
// This is the framework's native runtime component replacing the
// reference's serial C++ pack path (compressor.cpp:222-291 semantics:
// magnitude mask, (zeros_before, value) run-length pairs, int32/float32
// payload, .xz container with CRC64 at preset 6) — redesigned as a
// batch-parallel library: the device hands back a dense [N, XYZ]
// coefficient batch plus per-item float32 thresholds, and a worker pool
// packs every item concurrently (LZMA is the dominant host cost and scales
// across cores).  Exposed via a minimal C ABI consumed with ctypes
// (wavelet_tpu/native/__init__.py); byte format identical to io/archive.py.
//
// Three coefficient walks (strided / indexed / mapped) × two sinks:
//   wtc_pack_*     -> one file per item (reference-compatible layout)
//   wtc_encode_*   -> one malloc'd blob per item (bundle container mode;
//                     the caller appends them and frees via wtc_free_blob)
// and two sources on the unpack side:
//   wtc_unpack_*      -> read one file per item
//   wtc_unpack_*_mem  -> decode members handed in as (pointer, size) pairs
//                        (bundle mode)
//
// Build: see native/build.sh (g++ -O3 -march=native -shared ... -llzma).

#include <lzma.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

struct Pair {
    int32_t run;
    float   val;
};

#pragma pack(push, 1)
struct PairQ16 {
    int32_t run;
    int16_t val;
};
#pragma pack(pop)
static_assert(sizeof(PairQ16) == 6, "q16 pairs must be unpadded");

// --- vectorized threshold scan -------------------------------------------
//
// The pack-side hot loop is a keep-mask scan over every coefficient
// (|c| > thresh, strict — NaNs never kept, matching compressor.cpp:226's
// scalar fabs comparison).  At realistic kept fractions (1-5%) most 8-lane
// groups contain no kept value, so an AVX2 compare+movemask with an
// all-zero fast path runs the scan near memory bandwidth instead of the
// ~1 elem/3 cycles of the branchy scalar loop.  `run` carries the pending
// zero count across calls so multi-row/chunked items RLE identically to
// one continuous walk.

inline void scan_row(const float* row, int64_t n, float thresh,
                     int32_t& run, std::vector<Pair>& pairs) {
    int64_t k = 0;
#if defined(__AVX2__)
    const __m256 vt = _mm256_set1_ps(thresh);
    const __m256 abs_mask =
        _mm256_castsi256_ps(_mm256_set1_epi32(0x7fffffff));
    for (; k + 8 <= n; k += 8) {
        __m256 v = _mm256_loadu_ps(row + k);
        __m256 av = _mm256_and_ps(v, abs_mask);
        int m = _mm256_movemask_ps(_mm256_cmp_ps(av, vt, _CMP_GT_OQ));
        if (m == 0) {
            run += 8;
            continue;
        }
        int last = -1;
        while (m) {
            int b = __builtin_ctz(static_cast<unsigned>(m));
            m &= m - 1;
            run += b - last - 1;
            pairs.push_back({run, row[k + b]});
            run = 0;
            last = b;
        }
        run += 7 - last;
    }
#endif
    for (; k < n; ++k) {
        if (std::fabs(row[k]) > thresh) {
            pairs.push_back({run, row[k]});
            run = 0;
        } else {
            ++run;
        }
    }
}

// Does any element of a contiguous stretch pass the keep test?  Used as a
// row-skip fast path by the permuted (indexed) walk: kept coefficients are
// order-independent, so an all-below row contributes only run += n no
// matter how its elements are permuted into logical order.
inline bool row_any_kept(const float* row, int64_t n, float thresh) {
    int64_t k = 0;
#if defined(__AVX2__)
    const __m256 vt = _mm256_set1_ps(thresh);
    const __m256 abs_mask =
        _mm256_castsi256_ps(_mm256_set1_epi32(0x7fffffff));
    __m256 acc = _mm256_setzero_ps();
    for (; k + 8 <= n; k += 8) {
        __m256 v = _mm256_loadu_ps(row + k);
        acc = _mm256_or_ps(acc, _mm256_cmp_ps(
            _mm256_and_ps(v, abs_mask), vt, _CMP_GT_OQ));
    }
    if (_mm256_movemask_ps(acc)) return true;
#endif
    for (; k < n; ++k)
        if (std::fabs(row[k]) > thresh) return true;
    return false;
}

// True iff the table's values are exactly {0, 1, ..., n-1} (the inner-axis
// tables built by runtime/engine._index_tables are unit-stride
// permutations; a generic caller could pass arbitrary offsets, so the
// contiguous-footprint fast paths must verify before assuming).
bool is_unit_permutation(const int64_t* tab, int64_t n) {
    std::vector<bool> seen(n, false);
    for (int64_t i = 0; i < n; ++i) {
        int64_t v = tab[i];
        if (v < 0 || v >= n || seen[v]) return false;
        seen[v] = true;
    }
    return true;
}

// Items at or below this footprint take the memset-prepass unpack; larger
// ones take the write-once streaming walk (rationale at the use site).
// Default 4 MiB ~ the per-core L2/L3 share of small hosts; override with
// WTC_UNPACK_STREAM_BYTES for other cache hierarchies.
int64_t unpack_stream_threshold() {
    static const int64_t v = [] {
        const char* e = std::getenv("WTC_UNPACK_STREAM_BYTES");
        if (e && *e) {
            char* end = nullptr;
            const long long x = std::strtoll(e, &end, 10);
            if (end && *end == '\0' && x >= 0) return (int64_t)x;
        }
        return (int64_t)4 << 20;
    }();
    return v;
}

// --- payload serialization ------------------------------------------------

// Serialize one item's payload: 3x int32 shape, int32 total, int32 n_pairs,
// then (int32, float32) pairs.  Matches io/archive.serialize_payload.
std::string serialize_payload(const int32_t shape[3], int64_t total,
                              const std::vector<Pair>& pairs) {
    std::string buf;
    buf.reserve(20 + pairs.size() * 8);
    int32_t head[5] = {shape[0], shape[1], shape[2],
                       static_cast<int32_t>(total),
                       static_cast<int32_t>(pairs.size())};
    buf.append(reinterpret_cast<const char*>(head), sizeof(head));
    if (!pairs.empty()) {
        buf.append(reinterpret_cast<const char*>(pairs.data()),
                   pairs.size() * sizeof(Pair));
    }
    return buf;
}

// q16 extension payload: standard header + float32 scale + (int32, int16)
// pairs.  Matches io/archive.serialize_payload_q16 byte-for-byte, incl.
// numpy's rint (round-half-to-even) quantization.
std::string serialize_payload_q16(const int32_t shape[3], int64_t total,
                                  const std::vector<Pair>& pairs) {
    float maxmag = 0.0f;
    for (const auto& p : pairs) maxmag = std::max(maxmag, std::fabs(p.val));
    // divide in double then round once to f32, exactly like the Python
    // packer (float(max|v|) / 32767.0 packed as "<f") — an f32 divide
    // double-rounds and can differ by 1 ulp near rounding boundaries,
    // which would change the scale word AND every quantized value
    const float scale = pairs.empty()
        ? 0.0f
        : static_cast<float>(static_cast<double>(maxmag) / 32767.0);
    std::string buf;
    buf.reserve(24 + pairs.size() * sizeof(PairQ16));
    int32_t head[5] = {shape[0], shape[1], shape[2],
                       static_cast<int32_t>(total),
                       static_cast<int32_t>(pairs.size())};
    buf.append(reinterpret_cast<const char*>(head), sizeof(head));
    buf.append(reinterpret_cast<const char*>(&scale), sizeof(scale));
    std::vector<PairQ16> q(pairs.size());
    for (size_t i = 0; i < pairs.size(); ++i) {
        // numpy: np.clip(np.rint(v / float32(scale)), -32767, 32767).
        // scale == 0 (every kept value exactly 0.0): q must be 0, not
        // the clamp of 0/0 = NaN — the Python packer writes q=0 and the
        // two backends must stay byte-identical (io/archive.py).
        float r = scale == 0.0f ? 0.0f
                                : std::nearbyintf(pairs[i].val / scale);
        r = std::min(32767.0f, std::max(-32767.0f, r));
        q[i] = {pairs[i].run, static_cast<int16_t>(r)};
    }
    if (!q.empty())
        buf.append(reinterpret_cast<const char*>(q.data()),
                   q.size() * sizeof(PairQ16));
    return buf;
}

// q16 cannot represent inf/NaN: scale=inf would decode EVERY value in
// the box as NaN.  The Python packer raises for this (io/archive.py);
// the native walkers fail the item instead of silently destroying it.
static bool pairs_q16_ok(int payload_fmt, const std::vector<Pair>& pairs) {
    if (payload_fmt != 1) return true;
    for (const auto& p : pairs) if (!std::isfinite(p.val)) return false;
    return true;
}

std::string make_payload(int payload_fmt, const int32_t shape[3],
                         int64_t total, const std::vector<Pair>& pairs) {
    return payload_fmt == 1 ? serialize_payload_q16(shape, total, pairs)
                            : serialize_payload(shape, total, pairs);
}

// --- containers ------------------------------------------------------------

// codec 0 = xz container at the given preset (reference-compatible at 6);
// codec 1 = raw payload bytes (extension: no entropy stage, declared in
// wtc-meta.json; trades size for host-pack speed).  On success *data/*size
// view either `payload` itself (raw) or `scratch` (xz).
//
// Raw members are framed "WTCR" + CRC32(payload) little-endian + payload —
// xz carries CRC64 in-stream; frameless raw would decode a bit-flipped
// coefficient silently.  Must stay byte-identical to the Python framer
// (io/archive.py encode_blob).
static const uint8_t kRawMagic[4] = {'W', 'T', 'C', 'R'};

bool encode_container(const std::string& payload, int codec, int preset,
                      std::vector<uint8_t>& scratch,
                      const uint8_t** data, size_t* size) {
    if (codec == 1) {
        const uint32_t crc = lzma_crc32(
            reinterpret_cast<const uint8_t*>(payload.data()),
            payload.size(), 0);
        scratch.resize(8 + payload.size());
        std::memcpy(scratch.data(), kRawMagic, 4);
        scratch[4] = static_cast<uint8_t>(crc);
        scratch[5] = static_cast<uint8_t>(crc >> 8);
        scratch[6] = static_cast<uint8_t>(crc >> 16);
        scratch[7] = static_cast<uint8_t>(crc >> 24);
        std::memcpy(scratch.data() + 8, payload.data(), payload.size());
        *data = scratch.data();
        *size = scratch.size();
        return true;
    }
    // the preset word packs (low byte: xz preset, next byte: delta-filter
    // distance) — see io/archive.py pack_preset; a nonzero delta prepends
    // xz's delta filter.  NOTE: container framing legitimately differs
    // from the Python encoder (liblzma writes block-header size fields
    // the python module omits, for EVERY xz flavor) — the invariant is
    // payload identity after a generic decode, not container bytes.
    const uint32_t p = static_cast<uint32_t>(preset) & 0xFF;
    const uint32_t delta = (static_cast<uint32_t>(preset) >> 8) & 0xFF;
    scratch.resize(payload.size() + payload.size() / 3 + 256);
    size_t out_pos = 0;
    lzma_ret ret;
    if (delta) {
        lzma_options_delta dopt;
        std::memset(&dopt, 0, sizeof(dopt));
        dopt.type = LZMA_DELTA_TYPE_BYTE;
        dopt.dist = delta;
        lzma_options_lzma lopt;
        if (lzma_lzma_preset(&lopt, p)) return false;
        lzma_filter filters[3] = {
            {LZMA_FILTER_DELTA, &dopt},
            {LZMA_FILTER_LZMA2, &lopt},
            {LZMA_VLI_UNKNOWN, nullptr}};
        ret = lzma_stream_buffer_encode(
            filters, LZMA_CHECK_CRC64, nullptr,
            reinterpret_cast<const uint8_t*>(payload.data()),
            payload.size(), scratch.data(), &out_pos, scratch.size());
    } else {
        ret = lzma_easy_buffer_encode(
            p, LZMA_CHECK_CRC64, nullptr,
            reinterpret_cast<const uint8_t*>(payload.data()),
            payload.size(), scratch.data(), &out_pos, scratch.size());
    }
    if (ret != LZMA_OK) return false;
    *data = scratch.data();
    *size = out_pos;
    return true;
}

// Encode + write one item's container to `path` (temp-name + rename so a
// crash mid-write never leaves a truncated output that a resumed run
// (resume=1) would skip as complete).  Returns bytes written or -1.
int64_t encode_to_file(const std::string& payload, const char* path,
                       int codec, int preset) {
    std::vector<uint8_t> scratch;
    const uint8_t* data;
    size_t size;
    if (!encode_container(payload, codec, preset, scratch, &data, &size))
        return -1;
    // per-process temp name (two processes packing the same path must
    // not interleave into one temp file), removed on every failure path
    // so a full disk cannot strew orphan temps across the archive
    std::string tmp = std::string(path) + ".tmp." +
                      std::to_string(static_cast<long>(::getpid()));
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return -1;
    size_t w = std::fwrite(data, 1, size, f);
    std::fclose(f);
    if (w != size || std::rename(tmp.c_str(), path) != 0) {
        std::remove(tmp.c_str());
        return -1;
    }
    return static_cast<int64_t>(size);
}

// Encode one item's container into a malloc'd blob (bundle mode — the
// Python side appends blobs to the container file in item order and frees
// each via wtc_free_blob).  Returns bytes or -1.
int64_t encode_to_blob(const std::string& payload, int codec, int preset,
                       uint8_t** blob_out) {
    std::vector<uint8_t> scratch;
    const uint8_t* data;
    size_t size;
    if (!encode_container(payload, codec, preset, scratch, &data, &size))
        return -1;
    uint8_t* p = static_cast<uint8_t*>(std::malloc(size ? size : 1));
    if (!p) return -1;
    std::memcpy(p, data, size);
    *blob_out = p;
    return static_cast<int64_t>(size);
}

// Decode a container from memory into `payload` (xz: streaming decode with
// a growing buffer; raw: copy).
bool decode_container(const uint8_t* blob, size_t blob_size,
                      std::vector<uint8_t>& payload, int codec) {
    if (codec == 1) {
        if (blob_size >= 4 && std::memcmp(blob, kRawMagic, 4) == 0) {
            if (blob_size < 8) return false;   // truncated frame
            const uint32_t want =
                static_cast<uint32_t>(blob[4]) |
                (static_cast<uint32_t>(blob[5]) << 8) |
                (static_cast<uint32_t>(blob[6]) << 16) |
                (static_cast<uint32_t>(blob[7]) << 24);
            if (lzma_crc32(blob + 8, blob_size - 8, 0) != want)
                return false;                  // corrupt member
            payload.assign(blob + 8, blob + blob_size);
            return true;
        }
        payload.assign(blob, blob + blob_size);   // legacy frameless raw
        return true;
    }
    lzma_stream strm = LZMA_STREAM_INIT;
    if (lzma_stream_decoder(&strm, UINT64_MAX, LZMA_CONCATENATED) != LZMA_OK)
        return false;
    strm.next_in = blob;
    strm.avail_in = blob_size;
    payload.resize(blob_size * 4 + 4096);
    strm.next_out = payload.data();
    strm.avail_out = payload.size();
    for (;;) {
        lzma_ret ret = lzma_code(&strm, LZMA_FINISH);
        if (ret == LZMA_STREAM_END) break;
        if (ret != LZMA_OK) {
            lzma_end(&strm);
            return false;
        }
        size_t old = payload.size();
        payload.resize(old * 2);
        strm.next_out = payload.data() + old;
        strm.avail_out = old;
    }
    payload.resize(payload.size() - strm.avail_out);
    lzma_end(&strm);
    return true;
}

bool xz_decode_file(const char* path, std::vector<uint8_t>& payload,
                    int codec) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> blob(sz > 0 ? sz : 0);
    size_t r = blob.empty() ? 0 : std::fread(blob.data(), 1, blob.size(), f);
    std::fclose(f);
    if (r != blob.size()) return false;
    // no raw short-circuit: decode_container owns the raw-frame (CRC)
    // handling for both the file and in-memory paths
    return decode_container(blob.data(), blob.size(), payload, codec);
}

// Returns -1, or the index of the first item whose work threw (bad_alloc
// from a hostile xz bomb, etc.) — an exception escaping a std::thread
// start function would std::terminate the whole process, so workers catch
// everything and surface it as a per-item failure instead.
int64_t run_pool(int n_threads, int64_t n_items,
                 const std::function<void(int64_t)>& work) {
    std::atomic<int64_t> next(0);
    std::atomic<int64_t> thrown(-1);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_items ||
                thrown.load(std::memory_order_relaxed) >= 0)
                return;
            try {
                work(i);
            } catch (...) {
                int64_t expect = -1;
                thrown.compare_exchange_strong(expect, i);
            }
        }
    };
    std::vector<std::thread> threads;
    int nt = n_threads > 0 ? n_threads
                           : static_cast<int>(std::thread::hardware_concurrency());
    if (nt < 1) nt = 1;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
    return thrown.load();
}

// --- pack cores -------------------------------------------------------------
//
// Each core runs the coefficient walk + serialize on a worker pool and hands
// the payload to `emit(i, payload)` (returns bytes produced, or -1).  The
// two sinks: per-item files (reference layout) and per-item blobs (bundle).

// Item i's coefficients are `rows` runs of `row_len` floats spaced
// `row_stride` apart starting at coeffs + offsets[i] — the contiguous
// [N, XYZ] layout is rows=1; strided layouts walk without a host repack.
template <typename Emit>
int64_t pack_core_strided(const float* coeffs, const float* t32,
                          int64_t n_items, int64_t rows, int64_t row_len,
                          int64_t row_stride, const int64_t* offsets,
                          const int32_t* shape, int n_threads,
                          int payload_fmt, Emit emit) {
    const int64_t n_coeffs = rows * row_len;
    std::atomic<int64_t> total_bytes(0);
    std::atomic<int64_t> first_err(-1);
    const int64_t pool_thrown = run_pool(n_threads, n_items, [&](int64_t i) {
        const float* base = coeffs + offsets[i];
        const float thresh = t32[i];
        std::vector<Pair> pairs;
        int32_t run = 0;
        for (int64_t r = 0; r < rows; ++r)
            scan_row(base + r * row_stride, row_len, thresh, run, pairs);
        if (!pairs_q16_ok(payload_fmt, pairs)) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        int64_t n = emit(i, make_payload(payload_fmt, shape, n_coeffs,
                                         pairs));
        if (n < 0) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        total_bytes.fetch_add(n);
    });
    if (pool_thrown >= 0) return -(1 + pool_thrown);
    if (first_err.load() >= 0) return -(1 + first_err.load());
    return total_bytes.load();
}

// Indexed walk: item i's coefficient at LOGICAL position (a, b, c) (the
// reference's flatten order) lives at coeffs[offsets[i] + ix[a] + iy[b] +
// iz[c]] — the per-axis tables carry both the layout's strides and any
// in-place permutation (e.g. the interleaved Haar layout, where the device
// skips the low/high deinterleave and the host walks coefficients through
// core/interleave.interleave_perm instead).  Same payload bytes as the
// strided walk for the same logical data.
template <typename Emit>
int64_t pack_core_indexed(const float* coeffs, const float* t32,
                          int64_t n_items, int64_t nx, int64_t ny,
                          int64_t nz, const int64_t* ix, const int64_t* iy,
                          const int64_t* iz, const int64_t* offsets,
                          const int32_t* shape, int n_threads,
                          int payload_fmt, Emit emit) {
    const int64_t n_coeffs = nx * ny * nz;
    // inner-axis table with a contiguous {0..nz-1} footprint => each
    // logical z-row is a permutation of a contiguous physical row, so an
    // all-below physical row (the common case at few-percent kept
    // fractions) is detected with one vector scan and skipped whole
    const bool iz_unit = is_unit_permutation(iz, nz);
    std::atomic<int64_t> total_bytes(0);
    std::atomic<int64_t> first_err(-1);
    const int64_t pool_thrown = run_pool(n_threads, n_items, [&](int64_t i) {
        const float* base = coeffs + offsets[i];
        const float thresh = t32[i];
        std::vector<Pair> pairs;
        std::vector<float> buf(nz);
        int32_t run = 0;
        for (int64_t a = 0; a < nx; ++a) {
            const float* pa = base + ix[a];
            for (int64_t b = 0; b < ny; ++b) {
                const float* pb = pa + iy[b];
                if (iz_unit && !row_any_kept(pb, nz, thresh)) {
                    run += static_cast<int32_t>(nz);
                    continue;
                }
                // gather the row into logical order, then vector-scan it
                for (int64_t c = 0; c < nz; ++c) buf[c] = pb[iz[c]];
                scan_row(buf.data(), nz, thresh, run, pairs);
            }
        }
        if (!pairs_q16_ok(payload_fmt, pairs)) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        int64_t n = emit(i, make_payload(payload_fmt, shape, n_coeffs,
                                         pairs));
        if (n < 0) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        total_bytes.fetch_add(n);
    });
    if (pool_thrown >= 0) return -(1 + pool_thrown);
    if (first_err.load() >= 0) return -(1 + first_err.load());
    return total_bytes.load();
}

// Mapped walk: item i's coefficient at LOGICAL flat position t lives at
// coeffs[offsets[i] + map[t]].  The fully general layout walk — needed for
// the multi-scale interleaved layout, whose logical->physical map is NOT
// separable per axis (a high-band coordinate means the other axes were
// never re-transformed at deeper scales).  map has n_coeffs entries,
// shared by every item of the batch.
template <typename Emit>
int64_t pack_core_mapped(const float* coeffs, const float* t32,
                         int64_t n_items, int64_t n_coeffs,
                         const int64_t* map, const int64_t* offsets,
                         const int32_t* shape, int n_threads,
                         int payload_fmt, Emit emit) {
    std::atomic<int64_t> total_bytes(0);
    std::atomic<int64_t> first_err(-1);
    const int64_t pool_thrown = run_pool(n_threads, n_items, [&](int64_t i) {
        const float* base = coeffs + offsets[i];
        const float thresh = t32[i];
        std::vector<Pair> pairs;
        // chunked gather-to-buffer so the keep scan itself is vectorized
        // (the map is an arbitrary permutation; only the gather is scalar)
        constexpr int64_t kChunk = 4096;
        std::vector<float> buf(std::min(kChunk, n_coeffs));
        int32_t run = 0;
        for (int64_t t0 = 0; t0 < n_coeffs; t0 += kChunk) {
            const int64_t c = std::min(kChunk, n_coeffs - t0);
            const int64_t* mp = map + t0;
            for (int64_t j = 0; j < c; ++j) buf[j] = base[mp[j]];
            scan_row(buf.data(), c, thresh, run, pairs);
        }
        if (!pairs_q16_ok(payload_fmt, pairs)) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        int64_t n = emit(i, make_payload(payload_fmt, shape, n_coeffs,
                                         pairs));
        if (n < 0) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        total_bytes.fetch_add(n);
    });
    if (pool_thrown >= 0) return -(1 + pool_thrown);
    if (first_err.load() >= 0) return -(1 + first_err.load());
    return total_bytes.load();
}

struct FileEmit {
    const char* const* paths;
    int codec;
    int preset;
    int64_t operator()(int64_t i, const std::string& payload) const {
        return encode_to_file(payload, paths[i], codec, preset);
    }
};

struct BlobEmit {
    uint8_t** blobs;
    int64_t* sizes;
    int codec;
    int preset;
    int64_t operator()(int64_t i, const std::string& payload) const {
        int64_t n = encode_to_blob(payload, codec, preset, &blobs[i]);
        sizes[i] = n;
        return n;
    }
};

// --- unpack cores ------------------------------------------------------------
//
// Each core pulls one item's container via `load(i, payload)` (file read or
// bundle member), validates the header, zeroes the item's destination
// footprint, then scatters the RLE pairs.  Shared by the file and memory
// source variants.

struct PayloadView {
    const uint8_t* pd;   // pair data
    int64_t total;
    int64_t n_pairs;
    float scale;         // q16 dequant scale
};

// Header/bounds validation shared by every unpack walk; fills `view`.
bool parse_payload(const std::vector<uint8_t>& payload, int payload_fmt,
                   int64_t n_coeffs, int32_t* shapes_out_i,
                   PayloadView* view) {
    const size_t head_bytes = payload_fmt == 1 ? 24 : 20;
    const size_t pair_bytes =
        payload_fmt == 1 ? sizeof(PairQ16) : sizeof(Pair);
    if (payload.size() < head_bytes) return false;
    int32_t head[5];
    std::memcpy(head, payload.data(), sizeof(head));
    view->total = head[3];
    view->n_pairs = head[4];
    // total must equal the box volume exactly: the Python path rejects a
    // corrupt total (reshape failure / explicit check), and accepting a
    // short one here would silently zero-fill instead of erroring
    if (view->total != n_coeffs || view->n_pairs < 0 ||
        payload.size() < head_bytes + view->n_pairs * pair_bytes)
        return false;
    if (shapes_out_i)
        std::memcpy(shapes_out_i, head, 3 * sizeof(int32_t));
    view->scale = 0.0f;
    if (payload_fmt == 1)
        std::memcpy(&view->scale, payload.data() + 20, 4);
    view->pd = payload.data() + head_bytes;
    return true;
}

inline void read_pair(const PayloadView& v, int payload_fmt, int64_t p,
                      int32_t* run, float* val) {
    if (payload_fmt == 1) {
        PairQ16 q;
        std::memcpy(&q, v.pd + p * sizeof(PairQ16), sizeof(q));
        *run = q.run;
        *val = static_cast<float>(q.val) * v.scale;
    } else {
        Pair pr;
        std::memcpy(&pr, v.pd + p * sizeof(Pair), sizeof(pr));
        *run = pr.run;
        *val = pr.val;
    }
}

template <typename Load>
int64_t unpack_core_strided(int64_t n_items, int64_t rows, int64_t row_len,
                            int64_t row_stride, const int64_t* offsets,
                            float* out, int32_t* shapes_out, int n_threads,
                            int payload_fmt, Load load) {
    const int64_t n_coeffs = rows * row_len;
    std::atomic<int64_t> first_err(-1);
    const int64_t pool_thrown = run_pool(n_threads, n_items, [&](int64_t i) {
        std::vector<uint8_t> payload;
        PayloadView v;
        if (!load(i, payload) ||
            !parse_payload(payload, payload_fmt, n_coeffs,
                           shapes_out ? shapes_out + 3 * i : nullptr, &v)) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        float* base = out + offsets[i];
        // Two regimes, picked by item footprint (measured on the 4-core
        // build host, bench_results/host_codec.json):
        //  - cache-resident items: memset the whole footprint first, then
        //    scatter.  The prepass warms the cache, stores hit it, and RAM
        //    sees each byte once anyway — one big memset beats the many
        //    short ones a fused walk issues (6.8 vs 5.6 GB/s at 64^3/1%).
        //  - larger-than-cache items: a single sequential walk emits the
        //    zero runs in-pass so every byte is written ONCE; the memset
        //    prepass would stream the footprint through RAM twice.
        // Semantics are identical either way (decompressor.cpp:18-27 plus
        // the negative-run lower bound): a (malformed) backwards jump
        // lands in an already-emitted region and overwrites it, exactly
        // like the memset-first formulation.
        const int64_t item_bytes = n_coeffs * (int64_t)sizeof(float);
        if (item_bytes <= unpack_stream_threshold()) {
            for (int64_t r = 0; r < rows; ++r)
                std::memset(base + r * row_stride, 0,
                            row_len * sizeof(float));
            int64_t idx = 0;
            for (int64_t p = 0; p < v.n_pairs; ++p) {
                int32_t run;
                float val;
                read_pair(v, payload_fmt, p, &run, &val);
                idx += run;
                if (idx >= 0 && idx < v.total) {
                    base[(idx / row_len) * row_stride + idx % row_len] = val;
                    ++idx;
                }
            }
            return;
        }
        int64_t cursor = 0;                 // next logical slot not emitted
        int64_t idx = 0;
        if (row_stride == row_len) {        // contiguous item: no div ever
            for (int64_t p = 0; p < v.n_pairs; ++p) {
                int32_t run;
                float val;
                read_pair(v, payload_fmt, p, &run, &val);
                idx += run;
                if (idx >= 0 && idx < v.total) {
                    if (idx >= cursor) {
                        std::memset(base + cursor, 0,
                                    (idx - cursor) * sizeof(float));
                        cursor = idx + 1;
                    }
                    base[idx] = val;
                    ++idx;
                }
            }
            std::memset(base + cursor, 0, (v.total - cursor) * sizeof(float));
        } else {
            int64_t r_cur = 0, col_cur = 0;  // (row, col) of `cursor`
            for (int64_t p = 0; p < v.n_pairs; ++p) {
                int32_t run;
                float val;
                read_pair(v, payload_fmt, p, &run, &val);
                idx += run;
                if (idx >= 0 && idx < v.total) {
                    if (idx >= cursor) {
                        while (cursor < idx) {  // zero-fill, row by row
                            const int64_t span =
                                std::min(idx - cursor, row_len - col_cur);
                            std::memset(base + r_cur * row_stride + col_cur,
                                        0, span * sizeof(float));
                            cursor += span;
                            col_cur += span;
                            if (col_cur == row_len) { col_cur = 0; ++r_cur; }
                        }
                        base[r_cur * row_stride + col_cur] = val;
                        cursor = idx + 1;
                        if (++col_cur == row_len) { col_cur = 0; ++r_cur; }
                    } else {  // backwards jump: already-emitted region
                        base[(idx / row_len) * row_stride + idx % row_len] =
                            val;
                    }
                    ++idx;
                }
            }
            while (cursor < v.total) {
                const int64_t span =
                    std::min(v.total - cursor, row_len - col_cur);
                std::memset(base + r_cur * row_stride + col_cur, 0,
                            span * sizeof(float));
                cursor += span;
                col_cur += span;
                if (col_cur == row_len) { col_cur = 0; ++r_cur; }
            }
        }
    });
    if (pool_thrown >= 0) return -(1 + pool_thrown);
    if (first_err.load() >= 0) return -(1 + first_err.load());
    return 0;
}

template <typename Load>
int64_t unpack_core_indexed(int64_t n_items, int64_t nx, int64_t ny,
                            int64_t nz, const int64_t* ix, const int64_t* iy,
                            const int64_t* iz, const int64_t* offsets,
                            float* out, int32_t* shapes_out, int n_threads,
                            int payload_fmt, Load load) {
    const int64_t n_coeffs = nx * ny * nz;
    // unit-stride inner table => each (a, b) footprint is one contiguous
    // row, zeroable with a memset instead of nz scattered stores
    const bool iz_unit = is_unit_permutation(iz, nz);
    std::atomic<int64_t> first_err(-1);
    const int64_t pool_thrown = run_pool(n_threads, n_items, [&](int64_t i) {
        std::vector<uint8_t> payload;
        PayloadView v;
        if (!load(i, payload) ||
            !parse_payload(payload, payload_fmt, n_coeffs,
                           shapes_out ? shapes_out + 3 * i : nullptr, &v)) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        float* base = out + offsets[i];
        const bool small_item =
            n_coeffs * (int64_t)sizeof(float) <= unpack_stream_threshold();
        if (iz_unit && small_item) {
            // cache-resident: memset prepass + scatter (see the strided
            // core for the regime rationale)
            for (int64_t a = 0; a < nx; ++a)
                for (int64_t b = 0; b < ny; ++b)
                    std::memset(base + ix[a] + iy[b], 0, nz * sizeof(float));
            int64_t idx = 0;
            for (int64_t p = 0; p < v.n_pairs; ++p) {
                int32_t run;
                float val;
                read_pair(v, payload_fmt, p, &run, &val);
                idx += run;
                if (idx >= 0 && idx < v.total) {
                    base[ix[idx / (ny * nz)] + iy[(idx / nz) % ny] +
                         iz[idx % nz]] = val;
                    ++idx;
                }
            }
        } else if (iz_unit) {
            // Single forward walk with LAZY row zeroing: each (a, b) row's
            // contiguous nz-float footprint (iz is a permutation of
            // [0, nz), so the footprint is one memset-able span even
            // though iz[c] != c in general) is zeroed when the walk first
            // reaches it, then kept values land at iz[c].  Every byte is
            // written once plus the kept stores — the old
            // memset-everything prepass wrote items larger than L2 twice.
            // (a_cur, b_cur, col_cur) track the logical cursor and
            // (az, bz) the zeroing frontier; the hot path never divides.
            int64_t cursor = 0, idx = 0;
            int64_t a_cur = 0, b_cur = 0, col_cur = 0;
            int64_t az = 0, bz = 0, zeroed_rows = 0;
            const auto zero_through = [&](int64_t row) {
                while (zeroed_rows <= row) {
                    std::memset(base + ix[az] + iy[bz], 0,
                                nz * sizeof(float));
                    ++zeroed_rows;
                    if (++bz == ny) { bz = 0; ++az; }
                }
            };
            for (int64_t p = 0; p < v.n_pairs; ++p) {
                int32_t run;
                float val;
                read_pair(v, payload_fmt, p, &run, &val);
                idx += run;
                if (idx >= 0 && idx < v.total) {
                    if (idx >= cursor) {
                        col_cur += idx - cursor;
                        while (col_cur >= nz) {  // bounded by rows overall
                            col_cur -= nz;
                            if (++b_cur == ny) { b_cur = 0; ++a_cur; }
                        }
                        zero_through(a_cur * ny + b_cur);
                        base[ix[a_cur] + iy[b_cur] + iz[col_cur]] = val;
                        cursor = idx + 1;
                        if (++col_cur == nz) {
                            col_cur = 0;
                            if (++b_cur == ny) { b_cur = 0; ++a_cur; }
                        }
                    } else {  // backwards jump: already-zeroed region
                        base[ix[idx / (ny * nz)] + iy[(idx / nz) % ny] +
                             iz[idx % nz]] = val;
                    }
                    ++idx;
                }
            }
            zero_through(nx * ny - 1);
        } else {
            for (int64_t a = 0; a < nx; ++a)
                for (int64_t b = 0; b < ny; ++b)
                    for (int64_t c = 0; c < nz; ++c)
                        base[ix[a] + iy[b] + iz[c]] = 0.0f;
            int64_t idx = 0;
            for (int64_t p = 0; p < v.n_pairs; ++p) {
                int32_t run;
                float val;
                read_pair(v, payload_fmt, p, &run, &val);
                idx += run;
                if (idx >= 0 && idx < v.total) {
                    const int64_t c = idx % nz;
                    const int64_t b = (idx / nz) % ny;
                    const int64_t a = idx / (ny * nz);
                    base[ix[a] + iy[b] + iz[c]] = val;
                    ++idx;
                }
            }
        }
    });
    if (pool_thrown >= 0) return -(1 + pool_thrown);
    if (first_err.load() >= 0) return -(1 + first_err.load());
    return 0;
}

template <typename Load>
int64_t unpack_core_mapped(int64_t n_items, int64_t n_coeffs,
                           const int64_t* map, const int64_t* offsets,
                           float* out, int32_t* shapes_out, int n_threads,
                           int payload_fmt, Load load) {
    std::atomic<int64_t> first_err(-1);
    const int64_t pool_thrown = run_pool(n_threads, n_items, [&](int64_t i) {
        std::vector<uint8_t> payload;
        PayloadView v;
        if (!load(i, payload) ||
            !parse_payload(payload, payload_fmt, n_coeffs,
                           shapes_out ? shapes_out + 3 * i : nullptr, &v)) {
            int64_t expect = -1;
            first_err.compare_exchange_strong(expect, i);
            return;
        }
        float* base = out + offsets[i];
        for (int64_t t = 0; t < n_coeffs; ++t) base[map[t]] = 0.0f;
        int64_t idx = 0;
        for (int64_t p = 0; p < v.n_pairs; ++p) {
            int32_t run;
            float val;
            read_pair(v, payload_fmt, p, &run, &val);
            idx += run;
            if (idx >= 0 && idx < v.total) {
                base[map[idx]] = val;
                ++idx;
            }
        }
    });
    if (pool_thrown >= 0) return -(1 + pool_thrown);
    if (first_err.load() >= 0) return -(1 + first_err.load());
    return 0;
}

struct FileLoad {
    const char* const* paths;
    int codec;
    bool operator()(int64_t i, std::vector<uint8_t>& payload) const {
        return xz_decode_file(paths[i], payload, codec);
    }
};

struct MemLoad {
    const uint8_t* const* blobs;
    const int64_t* sizes;
    int codec;
    bool operator()(int64_t i, std::vector<uint8_t>& payload) const {
        if (sizes[i] < 0) return false;
        return decode_container(blobs[i], static_cast<size_t>(sizes[i]),
                                payload, codec);
    }
};

}  // namespace

extern "C" {

// ---- pack to per-item files (reference-compatible archive layout) ----

// Pack n_items items with per-item float32 thresholds (keep iff
// |c| > t32[i]); write one .xz per item at paths[i].  All items share one
// box shape.  Returns total compressed bytes, or -(1 + first failing item
// index) on error.
int64_t wtc_pack_strided(const float* coeffs, const float* t32,
                         int64_t n_items, int64_t rows, int64_t row_len,
                         int64_t row_stride, const int64_t* offsets,
                         const int32_t* shape, const char* const* paths,
                         int n_threads, int payload_fmt /*0=f32, 1=q16*/,
                         int codec /*0=xz, 1=raw*/, int preset /*xz 0-9*/) {
    return pack_core_strided(coeffs, t32, n_items, rows, row_len,
                             row_stride, offsets, shape, n_threads,
                             payload_fmt, FileEmit{paths, codec, preset});
}

int64_t wtc_pack_indexed(const float* coeffs, const float* t32,
                         int64_t n_items, int64_t nx, int64_t ny, int64_t nz,
                         const int64_t* ix, const int64_t* iy,
                         const int64_t* iz, const int64_t* offsets,
                         const int32_t* shape, const char* const* paths,
                         int n_threads, int payload_fmt, int codec,
                         int preset) {
    return pack_core_indexed(coeffs, t32, n_items, nx, ny, nz, ix, iy, iz,
                             offsets, shape, n_threads, payload_fmt,
                             FileEmit{paths, codec, preset});
}

int64_t wtc_pack_mapped(const float* coeffs, const float* t32,
                        int64_t n_items, int64_t n_coeffs,
                        const int64_t* map, const int64_t* offsets,
                        const int32_t* shape, const char* const* paths,
                        int n_threads, int payload_fmt, int codec,
                        int preset) {
    return pack_core_mapped(coeffs, t32, n_items, n_coeffs, map, offsets,
                            shape, n_threads, payload_fmt,
                            FileEmit{paths, codec, preset});
}

// ---- encode to per-item blobs (bundle container mode) ----
//
// Same walks and payload bytes as the wtc_pack_* functions, but each item's
// encoded container lands in a malloc'd buffer (blobs_out[i], sizes_out[i])
// instead of its own file; the caller appends them to the bundle in item
// order and frees each via wtc_free_blob.  Returns total bytes or
// -(1 + first failing item index) (failed calls still own any blobs with
// sizes_out[i] > 0 — the binding frees them).

int64_t wtc_encode_strided(const float* coeffs, const float* t32,
                           int64_t n_items, int64_t rows, int64_t row_len,
                           int64_t row_stride, const int64_t* offsets,
                           const int32_t* shape, uint8_t** blobs_out,
                           int64_t* sizes_out, int n_threads,
                           int payload_fmt, int codec, int preset) {
    return pack_core_strided(coeffs, t32, n_items, rows, row_len,
                             row_stride, offsets, shape, n_threads,
                             payload_fmt,
                             BlobEmit{blobs_out, sizes_out, codec, preset});
}

int64_t wtc_encode_indexed(const float* coeffs, const float* t32,
                           int64_t n_items, int64_t nx, int64_t ny,
                           int64_t nz, const int64_t* ix, const int64_t* iy,
                           const int64_t* iz, const int64_t* offsets,
                           const int32_t* shape, uint8_t** blobs_out,
                           int64_t* sizes_out, int n_threads,
                           int payload_fmt, int codec, int preset) {
    return pack_core_indexed(coeffs, t32, n_items, nx, ny, nz, ix, iy, iz,
                             offsets, shape, n_threads, payload_fmt,
                             BlobEmit{blobs_out, sizes_out, codec, preset});
}

int64_t wtc_encode_mapped(const float* coeffs, const float* t32,
                          int64_t n_items, int64_t n_coeffs,
                          const int64_t* map, const int64_t* offsets,
                          const int32_t* shape, uint8_t** blobs_out,
                          int64_t* sizes_out, int n_threads,
                          int payload_fmt, int codec, int preset) {
    return pack_core_mapped(coeffs, t32, n_items, n_coeffs, map, offsets,
                            shape, n_threads, payload_fmt,
                            BlobEmit{blobs_out, sizes_out, codec, preset});
}

void wtc_free_blob(uint8_t* p) { std::free(p); }

// ---- unpack from per-item files ----

// Unpack n_items .xz files into a strided destination (same geometry
// convention as wtc_pack_strided; the destination regions are zeroed
// first).  shapes_out (3*n_items, optional) receives each item's box
// shape.  Returns 0, or -(1 + first failing item index).
int64_t wtc_unpack_strided(const char* const* paths, int64_t n_items,
                           int64_t rows, int64_t row_len, int64_t row_stride,
                           const int64_t* offsets, float* out,
                           int32_t* shapes_out, int n_threads,
                           int payload_fmt /*0=f32, 1=q16*/,
                           int codec /*0=xz, 1=raw*/) {
    return unpack_core_strided(n_items, rows, row_len, row_stride, offsets,
                               out, shapes_out, n_threads, payload_fmt,
                               FileLoad{paths, codec});
}

int64_t wtc_unpack_indexed(const char* const* paths, int64_t n_items,
                           int64_t nx, int64_t ny, int64_t nz,
                           const int64_t* ix, const int64_t* iy,
                           const int64_t* iz, const int64_t* offsets,
                           float* out, int32_t* shapes_out, int n_threads,
                           int payload_fmt, int codec) {
    return unpack_core_indexed(n_items, nx, ny, nz, ix, iy, iz, offsets,
                               out, shapes_out, n_threads, payload_fmt,
                               FileLoad{paths, codec});
}

int64_t wtc_unpack_mapped(const char* const* paths, int64_t n_items,
                          int64_t n_coeffs, const int64_t* map,
                          const int64_t* offsets, float* out,
                          int32_t* shapes_out, int n_threads,
                          int payload_fmt, int codec) {
    return unpack_core_mapped(n_items, n_coeffs, map, offsets, out,
                              shapes_out, n_threads, payload_fmt,
                              FileLoad{paths, codec});
}

// ---- unpack from in-memory members (bundle container mode) ----

int64_t wtc_unpack_strided_mem(const uint8_t* const* blobs,
                               const int64_t* blob_sizes, int64_t n_items,
                               int64_t rows, int64_t row_len,
                               int64_t row_stride, const int64_t* offsets,
                               float* out, int32_t* shapes_out,
                               int n_threads, int payload_fmt, int codec) {
    return unpack_core_strided(n_items, rows, row_len, row_stride, offsets,
                               out, shapes_out, n_threads, payload_fmt,
                               MemLoad{blobs, blob_sizes, codec});
}

int64_t wtc_unpack_indexed_mem(const uint8_t* const* blobs,
                               const int64_t* blob_sizes, int64_t n_items,
                               int64_t nx, int64_t ny, int64_t nz,
                               const int64_t* ix, const int64_t* iy,
                               const int64_t* iz, const int64_t* offsets,
                               float* out, int32_t* shapes_out,
                               int n_threads, int payload_fmt, int codec) {
    return unpack_core_indexed(n_items, nx, ny, nz, ix, iy, iz, offsets,
                               out, shapes_out, n_threads, payload_fmt,
                               MemLoad{blobs, blob_sizes, codec});
}

int64_t wtc_unpack_mapped_mem(const uint8_t* const* blobs,
                              const int64_t* blob_sizes, int64_t n_items,
                              int64_t n_coeffs, const int64_t* map,
                              const int64_t* offsets, float* out,
                              int32_t* shapes_out, int n_threads,
                              int payload_fmt, int codec) {
    return unpack_core_mapped(n_items, n_coeffs, map, offsets, out,
                              shapes_out, n_threads, payload_fmt,
                              MemLoad{blobs, blob_sizes, codec});
}

// ---- FAB axis-reversal transpose (plotfile I/O hot path) ----
//
// AMReX FABs store x-fastest (C, Z, Y, X); the framework's boxes are
// (C, X, Y, Z) C-order.  NumPy's strided axis-reversal copy runs at
// ~0.3-1 GB/s (elementwise gather loops); these do the same permutation
// as a cache-blocked 2D transpose of each (x, z) plane, fused with the
// f32<->f64 width change, parallelized over (c, y) planes.  Measured
// ~6-14x (bench_results/plotfile_io.json before/after rows).
//
// write direction: src f32 (C, X, Y, Z) -> dst (C, Z, Y, X) f64 or f32.
// read direction:  src FAB (C, Z, Y, X) f64/f32 -> dst f32 (C, X, Y, Z).

}  // extern "C" (templates below need C++ linkage)

namespace {

// Tiling notes: for power-of-2 boxes the (x, z)-plane strides are 4 KiB
// multiples, so naive 32x32 plane blocks put every row in ONE L1 set and
// thrash (measured 0.24 GB/s/core — no better than NumPy).  The fix is
// the scratch-staged [kXTile, y, kZTile] tile described below: strided
// hops land only in a small contiguous buffer where 4K aliasing cannot
// thrash, and both memory-facing passes stream contiguous segments.

constexpr int64_t kXTile = 8;
constexpr int64_t kZTile = 8;

// Both directions stage through a contiguous L1-resident scratch tile of
// shape [kXTile, y, kZTile]: the gather pass streams short contiguous
// segments from the source (sequential within each row), the scatter pass
// streams contiguous segments into the destination, and the strided hops
// land only in the 32 KiB scratch where 4K aliasing cannot thrash.

template <typename D>
void transpose_xtile_w(const float* src, D* dst, int64_t c, int64_t xb,
                       int64_t xe, int64_t x, int64_t y, int64_t z,
                       float* scratch) {
    const float* sc = src + c * x * y * z;
    D* dc = dst + c * x * y * z;
    const int64_t tx = xe - xb;
    for (int64_t zb = 0; zb < z; zb += kZTile) {
        const int64_t tz = std::min(kZTile, z - zb);
        for (int64_t xx = 0; xx < tx; ++xx)
            for (int64_t yy = 0; yy < y; ++yy) {
                const float* s = sc + ((xb + xx) * y + yy) * z + zb;
                float* t = scratch + (xx * y + yy) * kZTile;
                for (int64_t zz = 0; zz < tz; ++zz) t[zz] = s[zz];
            }
        for (int64_t zz = 0; zz < tz; ++zz)
            for (int64_t yy = 0; yy < y; ++yy) {
                D* d = dc + ((zb + zz) * y + yy) * x + xb;
                const float* t = scratch + yy * kZTile + zz;
                for (int64_t xx = 0; xx < tx; ++xx)
                    d[xx] = static_cast<D>(t[xx * y * kZTile]);
            }
    }
}

template <typename S>
void transpose_xtile_r(const S* src, float* dst, int64_t c, int64_t xb,
                       int64_t xe, int64_t x, int64_t y, int64_t z,
                       S* scratch) {
    // mirror of transpose_xtile_w: scratch is [kZTile, y, kXTile] of S
    const S* sc = src + c * x * y * z;
    float* dc = dst + c * x * y * z;
    const int64_t tx = xe - xb;
    for (int64_t zb = 0; zb < z; zb += kZTile) {
        const int64_t tz = std::min(kZTile, z - zb);
        for (int64_t zz = 0; zz < tz; ++zz)
            for (int64_t yy = 0; yy < y; ++yy) {
                const S* s = sc + ((zb + zz) * y + yy) * x + xb;
                S* t = scratch + (zz * y + yy) * kXTile;
                for (int64_t xx = 0; xx < tx; ++xx) t[xx] = s[xx];
            }
        for (int64_t xx = 0; xx < tx; ++xx)
            for (int64_t yy = 0; yy < y; ++yy) {
                float* d = dc + ((xb + xx) * y + yy) * z + zb;
                const S* t = scratch + yy * kXTile + xx;
                for (int64_t zz = 0; zz < tz; ++zz)
                    d[zz] = static_cast<float>(t[zz * y * kXTile]);
            }
    }
}

}  // namespace

extern "C" {

// dst_f64: 1 writes doubles, 0 writes floats.  Returns 0, or -1 on a
// worker exception (cannot happen for this pure loop, kept for symmetry).
int64_t wtc_fab_from_boxes(const float* src, int64_t ncomp, int64_t x,
                           int64_t y, int64_t z, void* dst, int dst_f64,
                           int n_threads) {
    const int64_t ntx = (x + kXTile - 1) / kXTile;
    const int64_t thrown = run_pool(n_threads, ncomp * ntx, [&](int64_t u) {
        const int64_t c = u / ntx, xb = (u % ntx) * kXTile;
        const int64_t xe = std::min(xb + kXTile, x);
        std::vector<float> scratch(kXTile * y * kZTile);
        if (dst_f64)
            transpose_xtile_w(src, static_cast<double*>(dst), c, xb, xe,
                              x, y, z, scratch.data());
        else
            transpose_xtile_w(src, static_cast<float*>(dst), c, xb, xe,
                              x, y, z, scratch.data());
    });
    return thrown >= 0 ? -1 : 0;
}

int64_t wtc_boxes_from_fab(const void* src, int src_f64, int64_t ncomp,
                           int64_t x, int64_t y, int64_t z, float* dst,
                           int n_threads) {
    const int64_t ntx = (x + kXTile - 1) / kXTile;
    const int64_t thrown = run_pool(n_threads, ncomp * ntx, [&](int64_t u) {
        const int64_t c = u / ntx, xb = (u % ntx) * kXTile;
        const int64_t xe = std::min(xb + kXTile, x);
        if (src_f64) {
            std::vector<double> scratch(kZTile * y * kXTile);
            transpose_xtile_r(static_cast<const double*>(src), dst, c, xb,
                              xe, x, y, z, scratch.data());
        } else {
            std::vector<float> scratch(kZTile * y * kXTile);
            transpose_xtile_r(static_cast<const float*>(src), dst, c, xb,
                              xe, x, y, z, scratch.data());
        }
    });
    return thrown >= 0 ? -1 : 0;
}

}  // extern "C"
