// Port-owned copy of native/thinning.cpp (thin_volume, the simple-point table) and native/volume_ops.cpp (edt3d_sq_masked), rebuilt as the pipeline's EDT-and-thinning layer.
//
// The passes of run_pipeline's native route, each touching only what its
// answer needs:
//
//   sl_bounding_box  the foreground box of the frame mask; all-zero 8-byte
//                    words skipped, planes split over threads
//   sl_crop          the box copied out of the frame, rows over threads
//   sl_edt_sq_masked the banded exact squared EDT of edt3d_sq_masked; every
//                    element written once by the thread that scans its
//                    plane (no serial memset), and a flag per (z, y) row
//                    that holds foreground
//   sl_thin          thin_volume's sequential distance-ordered thinning,
//                    the same scan order, queue order and deletions
//   sl_sqrt_rows     sqrt of the distances, only on rows that hold any
//   sl_frame         the full-frame skeleton from the box skeleton
//
// Every pass takes `threaded`: the caller decides from the voxel count
// whether the OpenMP team is worth its start-up (the thinning's level
// loop is serial whatever it says).
//
// The thinning keeps thin_volume's order (the flat-index scan for seeds,
// per level the leftover of the level before and then the level's
// bucket, neighbours appended in cube-scan order) and answers the same
// tests, so it deletes the same voxels in the same order.  What each
// candidate costs is what changed:
//   - every voxel byte holds its foreground bit, the pending bit, a
//     "settled" bit and its admission level (the first distance level
//     whose threshold its squared distance meets), so the hot loop reads
//     the float distances only past level 30;
//   - the box's faces hold no foreground (a volume whose faces do is
//     thinned in a copy with a one-voxel zero border), so neighbours are
//     flat offsets with no bounds checks and queue entries are flat
//     indices never divided into (z, y, x);
//   - a voxel that failed the test after its level admitted it is
//     "settled" until a neighbour is deleted: the test would answer the
//     same, so it is not asked again.  Deletions are the only change to a
//     neighbourhood, and each clears the bit of its 26 neighbours;
//   - one gather of the cube (nine 4-byte rows, SSE2 where the compiler
//     has it) gives the neighbours' foreground, pending and settled bits,
//     so a deletion visits only the neighbours that are not pending, and
//     their background 6-neighbours inside the cube are known from it;
//   - the cube rows of the queue entry 16 ahead are prefetched, and the
//     seeds are collected over threads.
//
// Build: with the rest of the port's native sources (ops/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <unistd.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// The simple-point table (native/thinning.cpp:38-257): the same tables,
// the same (26, 6) test and the same cache file format, so both copies
// read one file.

int OFF[26][3];
bool off_init = false;
uint32_t ADJ26_MASK[26];
uint32_t ADJ6_MASK[18];
int N18[18];
uint32_t FACE_MASK18;
uint32_t FACE_MASK26;
// for each neighbour k of a cube's centre: the neighbours of the centre
// that are 6-adjacent to k (IN6_MASK), and k's 6-neighbours outside the
// cube (OUT6, OUT6_N of them); the centre itself is 6-adjacent to k only
// for the six face neighbours
uint32_t IN6_MASK[26];
int OUT6[26][3][3];
int OUT6_N[26];

void init_tables() {
    if (off_init) return;
    int k = 0;
    for (int dz = -1; dz <= 1; ++dz)
        for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
                if (!dz && !dy && !dx) continue;
                OFF[k][0] = dz; OFF[k][1] = dy; OFF[k][2] = dx; ++k;
            }
    for (int i = 0; i < 26; ++i) {
        ADJ26_MASK[i] = 0;
        for (int j = 0; j < 26; ++j) {
            if (i == j) continue;
            int dz = std::abs(OFF[i][0] - OFF[j][0]);
            int dy = std::abs(OFF[i][1] - OFF[j][1]);
            int dx = std::abs(OFF[i][2] - OFF[j][2]);
            if (std::max(dz, std::max(dy, dx)) == 1)
                ADJ26_MASK[i] |= 1u << j;
        }
    }
    int m = 0;
    FACE_MASK18 = 0;
    FACE_MASK26 = 0;
    for (int i = 0; i < 26; ++i) {
        int man = std::abs(OFF[i][0]) + std::abs(OFF[i][1])
                + std::abs(OFF[i][2]);
        if (man == 1) FACE_MASK26 |= 1u << i;
        if (man <= 2) {
            if (man == 1) FACE_MASK18 |= 1u << m;
            N18[m++] = i;
        }
    }
    for (int a = 0; a < 18; ++a) {
        ADJ6_MASK[a] = 0;
        for (int b = 0; b < 18; ++b) {
            if (a == b) continue;
            int i = N18[a], j = N18[b];
            int man = std::abs(OFF[i][0] - OFF[j][0])
                    + std::abs(OFF[i][1] - OFF[j][1])
                    + std::abs(OFF[i][2] - OFF[j][2]);
            if (man == 1) ADJ6_MASK[a] |= 1u << b;
        }
    }
    for (int a = 0; a < 26; ++a) {
        IN6_MASK[a] = 0;
        OUT6_N[a] = 0;
        static const int kSix[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                                      {0, 1, 0}, {0, 0, -1}, {0, 0, 1}};
        for (const auto& d : kSix) {
            const int z = OFF[a][0] + d[0], y = OFF[a][1] + d[1],
                      x = OFF[a][2] + d[2];
            if (!z && !y && !x) continue;
            if (std::abs(z) > 1 || std::abs(y) > 1 || std::abs(x) > 1) {
                int* o = OUT6[a][OUT6_N[a]++];
                o[0] = z; o[1] = y; o[2] = x;
                continue;
            }
            for (int b = 0; b < 26; ++b)
                if (OFF[b][0] == z && OFF[b][1] == y && OFF[b][2] == x)
                    IN6_MASK[a] |= 1u << b;
        }
    }
    off_init = true;
}

// fixed point of reach |= (neighbours of reach) & domain
inline uint32_t grow_mask(uint32_t seed, uint32_t domain,
                          const uint32_t* adj) {
    uint32_t reach = seed, frontier = seed;
    while (frontier) {
        uint32_t nbrs = 0;
        do {
            int j = __builtin_ctz(frontier);
            nbrs |= adj[j];
            frontier &= frontier - 1;
        } while (frontier);
        frontier = nbrs & domain & ~reach;
        reach |= frontier;
    }
    return reach;
}

// T26 == 1 and T6 == 1 for the 26-bit neighbourhood code m26
bool is_simple_code(uint32_t m26) {
    if (!m26) return false;
    uint32_t seed = m26 & (~m26 + 1);
    if (grow_mask(seed, m26, ADJ26_MASK) != m26) return false;
    uint32_t m18 = 0;
    for (int a = 0; a < 18; ++a)
        if ((m26 >> N18[a]) & 1u) m18 |= 1u << a;
    uint32_t bg = ~m18 & 0x3FFFFu;
    uint32_t faces = bg & FACE_MASK18;
    if (!faces) return false;
    uint32_t seed6 = faces & (~faces + 1);
    uint32_t reach = grow_mask(seed6, bg, ADJ6_MASK);
    return (faces & ~reach) == 0;
}

const uint8_t* SIMPLE_LUT = nullptr;
std::vector<uint8_t> lut_store;
const char kLutMagic[8] = {'S', 'P', 'L', 'U', 'T', '2', '6', '\x01'};

int ensure_lut(const char* cache_path) {
    init_tables();
    if (SIMPLE_LUT) return 1;
    const size_t bytes = (1u << 26) / 8;
    lut_store.assign(bytes, 0);
    if (cache_path && *cache_path) {
        FILE* f = std::fopen(cache_path, "rb");
        if (f) {
            char magic[8] = {0};
            bool ok = std::fread(magic, 1, 8, f) == 8
                && std::memcmp(magic, kLutMagic, 8) == 0
                && std::fread(lut_store.data(), 1, bytes, f) == bytes
                && std::fgetc(f) == EOF;
            std::fclose(f);
            if (ok) {
                SIMPLE_LUT = lut_store.data();
                return 1;
            }
            std::fill(lut_store.begin(), lut_store.end(), 0);
        }
    }
    for (uint32_t code = 0; code < (1u << 26); ++code)
        if (is_simple_code(code))
            lut_store[code >> 3] |= static_cast<uint8_t>(1u << (code & 7));
    if (cache_path && *cache_path) {
        // a name of this process's own: another process may be writing
        std::string tmp = std::string(cache_path) + "."
            + std::to_string(static_cast<long>(getpid())) + ".tmp";
        FILE* w = std::fopen(tmp.c_str(), "wb");
        if (w) {
            size_t put = std::fwrite(kLutMagic, 1, 8, w);
            put += std::fwrite(lut_store.data(), 1, bytes, w);
            std::fclose(w);
            if (put == bytes + 8)
                std::rename(tmp.c_str(), cache_path);
            else
                std::remove(tmp.c_str());
        }
    }
    SIMPLE_LUT = lut_store.data();
    return 2;
}

inline uint64_t load8(const uint8_t* p) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    return w;
}

// index of the first / last nonzero byte of p[0, n), or -1
inline long first_nonzero(const uint8_t* p, long n) {
    long i = 0;
    for (; i + 8 <= n; i += 8)
        if (load8(p + i)) break;
    for (; i < n; ++i)
        if (p[i]) return i;
    return -1;
}

inline long last_nonzero(const uint8_t* p, long n) {
    long i = n;
    for (; i >= 8; i -= 8)
        if (load8(p + i - 8)) break;
    for (; i > 0; --i)
        if (p[i - 1]) return i - 1;
    return -1;
}

// ---------------------------------------------------------------------------
// The thinning's voxel byte: bit 0 foreground, bit 1 pending (in a queue,
// bucket or leftover), bit 2 settled, bits 3-7 the admission level,
// saturated at kLevelCap (the level is then read from the distances).
constexpr uint8_t kFg = 1;
constexpr uint8_t kPend = 2;
constexpr uint8_t kSettled = 4;
constexpr int kLevelShift = 3;
constexpr int kLevelCap = 31;
// queue entries the thinning loads ahead of the one it tests
constexpr size_t kPrefetch = 16;

// thin_volume's level of a squared distance: the first level >= `from`
// whose threshold level^2 + 0.5 the distance does not pass, at most
// max_level + 1 (the float comparisons are thin_volume's own)
inline int level_of(float d2, int from, int max_level) {
    int lvl = from;
    while (lvl <= max_level && static_cast<float>(lvl) * lvl + 0.5f < d2)
        ++lvl;
    return lvl;
}

struct Thin {
    uint8_t* v;          // the work volume (the box, or its bordered copy)
    long plane, row;     // strides of v
    const float* d2;     // distances, indexed by the box's flat index
    long d2_plane, d2_row, border;
    int max_level;
    bool preserve_endpoints;
    long foff[26];
    long out6[26][3];
    long rowoff[9];      // the cube's rows, from their x - 1 byte
    long n_work;         // bytes in v
    long tests = 0, deletions = 0;
    std::vector<long> queue, leftover;
    std::vector<std::vector<long>> buckets;

    // the box index of work index i (the distances' layout)
    inline long box_index(long i) const {
        if (!border) return i;
        long z = i / plane, r = i % plane;
        return (z - 1) * d2_plane + (r / row - 1) * d2_row + r % row - 1;
    }

    inline int admission(long i) const {
        int s = v[i] >> kLevelShift;
        if (s < kLevelCap) return s;
        return d2 ? level_of(d2[box_index(i)], 1, max_level) : 1;
    }

    inline bool has_bg6(long i) const {
        return !v[i - 1] || !v[i + 1] || !v[i - row] || !v[i + row]
            || !v[i - plane] || !v[i + plane];
    }

    // the 26 neighbours of i, cube-scan order: foreground, pending and
    // settled bits
    struct Nb { uint32_t fg, pend, settled; };

    inline Nb gather(long i) const {
        const uint8_t* c = v + i;
#if defined(__SSE2__)
        // nine rows of the cube, four bytes each (x - 1 .. x + 2; the
        // last is dropped), when the last row's fourth byte is in v
        if (i + plane + row + 2 < n_work) {
            uint32_t w[9];
            for (int r = 0; r < 9; ++r) std::memcpy(&w[r], c + rowoff[r], 4);
            const __m128i a = _mm_set_epi32(static_cast<int>(w[3]),
                static_cast<int>(w[2]), static_cast<int>(w[1]),
                static_cast<int>(w[0]));
            const __m128i b = _mm_set_epi32(static_cast<int>(w[7]),
                static_cast<int>(w[6]), static_cast<int>(w[5]),
                static_cast<int>(w[4]));
            const __m128i e = _mm_cvtsi32_si128(static_cast<int>(w[8]));
            const __m128i zero = _mm_setzero_si128();
            auto cube = [](uint32_t ma, uint32_t mb, uint32_t me) {
                // 4 bits a row -> 3 bits a row, 27 in all; centre out
                auto rows3 = [](uint32_t m) {
                    return (m & 7u) | ((m >> 1) & 0x38u)
                        | ((m >> 2) & 0x1C0u) | ((m >> 3) & 0xE00u);
                };
                const uint32_t m27 = rows3(ma) | (rows3(mb) << 12)
                    | ((me & 7u) << 24);
                return (m27 & 0x1FFFu) | ((m27 >> 14) << 13);
            };
            const auto nz = [&](__m128i x) {
                return ~static_cast<uint32_t>(
                    _mm_movemask_epi8(_mm_cmpeq_epi8(x, zero))) & 0xFFFFu;
            };
            const auto bit = [](__m128i x, int up) {
                return static_cast<uint32_t>(
                    _mm_movemask_epi8(_mm_slli_epi16(x, up)));
            };
            return {cube(nz(a), nz(b), nz(e)),
                    cube(bit(a, 6), bit(b, 6), bit(e, 6)),
                    cube(bit(a, 5), bit(b, 5), bit(e, 5))};
        }
#endif
        Nb n{0, 0, 0};
        for (int k = 0; k < 26; ++k) {
            const uint32_t b = c[foff[k]];
            n.fg |= static_cast<uint32_t>(b != 0) << k;
            n.pend |= ((b >> 1) & 1u) << k;
            n.settled |= ((b >> 2) & 1u) << k;
        }
        return n;
    }

    // j = i + foff[k] has a background 6-neighbour, i just deleted and
    // m26 its neighbourhood before: only k's 6-neighbours outside i's
    // cube are read
    inline bool has_bg6_after(long i, int k, uint32_t m26) const {
        if ((FACE_MASK26 >> k) & 1u) return true;
        if ((m26 & IN6_MASK[k]) != IN6_MASK[k]) return true;
        for (int t = 0; t < OUT6_N[k]; ++t)
            if (!v[i + out6[k][t]]) return true;
        return false;
    }

    // thin_volume's consider(): the deletion test at `level`; nb gets
    // the neighbourhood of a deleted voxel
    inline bool consider(long i, int level, Nb& nb) {
        uint8_t b = v[i];
        if (!b) return false;
        if (b & kSettled) return false;
        if (level <= max_level && admission(i) > level) return false;
        nb = gather(i);
        const uint32_t m26 = nb.fg;
        bool del = (m26 & FACE_MASK26) != FACE_MASK26
            && !(preserve_endpoints && __builtin_popcount(m26) <= 1);
        if (del) {
            ++tests;
            del = (SIMPLE_LUT[m26 >> 3] >> (m26 & 7)) & 1u;
        }
        if (!del) {
            v[i] = b | kSettled;
            return false;
        }
        v[i] = 0;
        ++deletions;
        return true;
    }

    void run() {
        for (int level = 1; level <= max_level + 1; ++level) {
            queue.clear();
            queue.swap(leftover);
            if (level < static_cast<int>(buckets.size())) {
                queue.insert(queue.end(), buckets[level].begin(),
                             buckets[level].end());
                std::vector<long>().swap(buckets[level]);
            }
            for (size_t qi = 0; qi < queue.size(); ++qi) {
                const long i = queue[qi];
                // the cube rows of the entry kPrefetch ahead (its lines
                // are rarely cached: entries are sparse in the box)
                if (qi + kPrefetch < queue.size()) {
                    const uint8_t* q = v + queue[qi + kPrefetch];
                    for (int r = 0; r < 9; ++r)
                        __builtin_prefetch(q + rowoff[r]);
                }
                v[i] &= static_cast<uint8_t>(~kPend);
                Nb nb;
                if (!consider(i, level, nb)) {
                    if (v[i] && level <= max_level) {
                        v[i] |= kPend;
                        leftover.push_back(i);
                    }
                    continue;
                }
                // a deletion unsettles every neighbour, and re-examines
                // those not pending, in cube-scan order
                for (uint32_t m = nb.settled; m; m &= m - 1)
                    v[i + foff[__builtin_ctz(m)]] &=
                        static_cast<uint8_t>(~kSettled);
                for (uint32_t m = nb.fg & ~nb.pend; m; m &= m - 1) {
                    const int k = __builtin_ctz(m);
                    if (!has_bg6_after(i, k, nb.fg)) continue;
                    const long j = i + foff[k];
                    const uint8_t b = v[j];
                    // thin_volume's `dist2[j] <= lvl2`, else the bucket
                    // of j's level past this one
                    bool now = true;
                    int aj = 0;
                    const int s = b >> kLevelShift;
                    if (level > max_level) {
                    } else if (s < kLevelCap) {
                        aj = s;
                        now = s <= level;
                    } else if (d2) {
                        const float dj = d2[box_index(j)];
                        now = dj <= static_cast<float>(level) * level + 0.5f;
                        if (!now) aj = level_of(dj, level + 1, max_level);
                    }
                    v[j] = b | kPend;
                    if (now)
                        queue.push_back(j);
                    else
                        buckets[aj].push_back(j);
                }
            }
        }
    }
};

}  // namespace

extern "C" {

// Loads (or makes and caches) the layer's simple-point table.  Returns 1
// if read from cache_path, 2 if made.
int sl_ensure_simple_lut(const char* cache_path) {
    return ensure_lut(cache_path);
}

// Foreground box of a (nz, ny, nx) uint8 volume, nonzero = foreground:
// out6 = z0, z1, y0, y1, x0, x1 (inclusive).  Returns 0 for an empty
// volume (out6 untouched), else 1.
int sl_bounding_box(const uint8_t* m, int nz, int ny, int nx, int threaded,
                    int64_t* out6) {
    long z0 = nz, z1 = -1, y0 = ny, y1 = -1, x0 = nx, x1 = -1;
    const long plane = static_cast<long>(ny) * nx;
#pragma omp parallel for schedule(dynamic, 4) if (threaded) \
    reduction(min : z0, y0, x0) reduction(max : z1, y1, x1)
    for (int z = 0; z < nz; ++z) {
        const uint8_t* p = m + z * plane;
        // a plane with no foreground is skipped in one word-skipping pass
        const long f = first_nonzero(p, plane);
        if (f < 0) continue;
        const long l = last_nonzero(p, plane);
        // the plane's x range: each row searched only outside the range
        // found so far
        long px0 = nx, px1 = -1;
        for (long y = f / nx; y <= l / nx; ++y) {
            const uint8_t* r = p + y * nx;
            const long a = first_nonzero(r, px0);
            if (a >= 0) px0 = a;
            const long b = last_nonzero(r + px1 + 1, nx - px1 - 1);
            if (b >= 0) px1 = px1 + 1 + b;
        }
        z0 = std::min(z0, static_cast<long>(z));
        z1 = std::max(z1, static_cast<long>(z));
        y0 = std::min(y0, f / nx);
        y1 = std::max(y1, l / nx);
        x0 = std::min(x0, px0);
        x1 = std::max(x1, px1);
    }
    if (z1 < 0) return 0;
    out6[0] = z0; out6[1] = z1; out6[2] = y0; out6[3] = y1;
    out6[4] = x0; out6[5] = x1;
    return 1;
}

// out (bz, by, bx) = m[z0:z0+bz, y0:y0+by, x0:x0+bx], bytes as they are
void sl_crop(const uint8_t* m, int nz, int ny, int nx, int z0, int y0,
             int x0, int bz, int by, int bx, uint8_t* out, int threaded) {
    (void)nz;
    const long plane = static_cast<long>(ny) * nx;
#pragma omp parallel for schedule(static) if (threaded)
    for (long r = 0; r < static_cast<long>(bz) * by; ++r) {
        const long z = r / by, y = r % by;
        std::memcpy(out + r * bx, m + (z0 + z) * plane + (y0 + y) * nx + x0,
                    bx);
    }
}

// edt3d_sq_masked (native/volume_ops.cpp:184-325), the same values: out
// is the exact squared distance to background at foreground voxels
// (1e15 where none lies within r_max) and 0 elsewhere.  Every element is
// written once, by the thread that scans its plane; row_fg (nz * ny
// bytes, may be null) gets 1 for each (z, y) row that holds foreground.
// The scan's seeded lower bound reads the row before (same plane) and
// the plane before only when this thread wrote it: the bound then holds,
// and the answer never depended on it.  Returns the unresolved count.
long sl_edt_sq_masked(const uint8_t* mask, int nz, int ny, int nx,
                      int r_max, float* out, uint8_t* row_fg,
                      int threaded) {
    constexpr float kLarge = 1e15f;
    const long plane = static_cast<long>(ny) * nx;
    const long r2max = static_cast<long>(r_max) * r_max;

    struct Off { int32_t d2; int16_t dz, dy, dx; };
    std::vector<Off> offs;
    offs.reserve(static_cast<size_t>(4.2 * r_max * r_max * r_max) + 64);
    for (int dz = -r_max; dz <= r_max; ++dz)
        for (int dy = -r_max; dy <= r_max; ++dy)
            for (int dx = -r_max; dx <= r_max; ++dx) {
                long d2 = static_cast<long>(dz) * dz
                        + static_cast<long>(dy) * dy
                        + static_cast<long>(dx) * dx;
                if (d2 == 0 || d2 > r2max) continue;
                offs.push_back({static_cast<int32_t>(d2),
                                static_cast<int16_t>(dz),
                                static_cast<int16_t>(dy),
                                static_cast<int16_t>(dx)});
            }
    std::sort(offs.begin(), offs.end(),
              [](const Off& a, const Off& b) { return a.d2 < b.d2; });
    const size_t n_off = offs.size();
    std::vector<long> flat(n_off);
    for (size_t i = 0; i < n_off; ++i)
        flat[i] = (static_cast<long>(offs[i].dz) * ny + offs[i].dy) * nx
                + offs[i].dx;
    std::vector<int32_t> start_at(static_cast<size_t>(r2max) + 2, 0);
    {
        size_t i = 0;
        for (long k = 0; k <= r2max + 1; ++k) {
            while (i < n_off && offs[i].d2 < k) ++i;
            start_at[k] = static_cast<int32_t>(i);
        }
    }

    // planes in chunks: a chunk is one thread's, scanned in order
    const int chunk = threaded ? 4 : std::max(nz, 1);
    const int n_chunks = (nz + chunk - 1) / chunk;
    long unresolved = 0;
#pragma omp parallel for schedule(dynamic, 1) if (threaded) \
    reduction(+ : unresolved)
    for (int c = 0; c < n_chunks; ++c) {
        const int zc0 = c * chunk, zc1 = std::min(nz, zc0 + chunk);
        for (int z = zc0; z < zc1; ++z) {
            const bool z_in = (z >= r_max && z < nz - r_max);
            const bool z_prev = z > zc0;
            for (int y = 0; y < ny; ++y) {
                const bool zy_in = z_in && y >= r_max && y < ny - r_max;
                const long row = (static_cast<long>(z) * ny + y) * nx;
                float prev_d2 = 0.0f;
                uint8_t any = 0;
                for (int x = 0; x < nx; ++x) {
                    if (!(x & 7) && x + 8 <= nx) {
                        if (!load8(mask + row + x)) {
                            std::memset(out + row + x, 0, 8 * sizeof(float));
                            x += 7;
                            prev_d2 = 0.0f;
                            continue;
                        }
                    }
                    const long p = row + x;
                    if (!mask[p]) {
                        out[p] = 0.0f;
                        prev_d2 = 0.0f;
                        continue;
                    }
                    any = 1;
                    float nb = prev_d2;
                    if (y > 0 && mask[p - nx] && out[p - nx] > nb)
                        nb = out[p - nx];
                    if (z_prev && mask[p - plane] && out[p - plane] > nb)
                        nb = out[p - plane];
                    size_t i0 = 0;
                    if (nb > 4.0f) {
                        if (nb > static_cast<float>(r2max))
                            nb = static_cast<float>(r2max);
                        const float lb2 = nb - 2.0f * std::sqrt(nb);
                        if (lb2 > 0.0f)
                            i0 = static_cast<size_t>(
                                start_at[static_cast<long>(lb2)]);
                    }
                    float d2 = kLarge;
                    if (zy_in && x >= r_max && x < nx - r_max) {
                        for (size_t i = i0; i < n_off; ++i) {
                            if (!mask[p + flat[i]]) {
                                d2 = static_cast<float>(offs[i].d2);
                                break;
                            }
                        }
                    } else {
                        for (size_t i = i0; i < n_off; ++i) {
                            const int z2 = z + offs[i].dz;
                            const int y2 = y + offs[i].dy;
                            const int x2 = x + offs[i].dx;
                            if (z2 < 0 || z2 >= nz || y2 < 0 || y2 >= ny
                                || x2 < 0 || x2 >= nx) continue;
                            if (!mask[p + flat[i]]) {
                                d2 = static_cast<float>(offs[i].d2);
                                break;
                            }
                        }
                    }
                    out[p] = d2;
                    prev_d2 = d2;
                    if (d2 >= kLarge) ++unresolved;
                }
                if (row_fg) row_fg[static_cast<long>(z) * ny + y] = any;
            }
        }
    }
    return unresolved;
}

// In-place thinning of a (nz, ny, nx) uint8 volume (nonzero =
// foreground) in distance order: the voxels thin_volume deletes, in its
// order, for every 0/1 volume.  A byte other than 0 and 1 counts as
// foreground here (thin_volume reads bit 1 as its pending flag).  dist2
// (optional) are the squared distances; stats (optional, 2 longs) get
// the simple-point tests and the deletions.  Returns the deletions.
long sl_thin(uint8_t* vol, int nz, int ny, int nx, const float* dist2,
             int preserve_endpoints, int threaded, long* stats) {
    init_tables();
    if (!SIMPLE_LUT) ensure_lut(nullptr);
    const long row = nx, plane = static_cast<long>(ny) * nx;
    const long n = static_cast<long>(nz) * plane;

    // pass 1: every foreground byte becomes 1 | its admission level
    // (levels past the byte's are read from the distances later, so
    // max_level is not needed yet); the largest distance, and whether a
    // face holds foreground
    float max_d2 = 1.0f;
    int on_face = 0;
#pragma omp parallel for schedule(dynamic, 4) if (threaded) \
    reduction(max : max_d2) reduction(| : on_face)
    for (int z = 0; z < nz; ++z) {
        for (int y = 0; y < ny; ++y) {
            const long r = z * plane + y * row;
            const bool face_row = z == 0 || z == nz - 1 || y == 0
                || y == ny - 1;
            for (long x = 0; x < nx; ++x) {
                if (!(x & 7) && x + 8 <= nx && !load8(vol + r + x)) {
                    x += 7;
                    continue;
                }
                if (!vol[r + x]) continue;
                if (face_row || x == 0 || x == nx - 1) on_face = 1;
                int lvl = 1;
                if (dist2) {
                    // a NaN distance keeps the saturated level: its
                    // comparisons are then thin_volume's own on the float
                    const float d = dist2[r + x];
                    if (d > max_d2) max_d2 = d;
                    lvl = d != d ? kLevelCap : level_of(d, 1, kLevelCap - 1);
                }
                vol[r + x] = static_cast<uint8_t>(kFg | (lvl << kLevelShift));
            }
        }
    }
    Thin t;
    t.max_level = dist2 ? static_cast<int>(std::sqrt(max_d2)) + 1 : 1;
    t.preserve_endpoints = preserve_endpoints != 0;
    t.d2 = dist2;
    t.d2_plane = plane;
    t.d2_row = row;

    // a face with foreground: thin a copy inside a one-voxel zero border
    std::vector<uint8_t> bordered;
    long wz = nz, wy = ny, wx = nx;
    if (on_face) {
        wz = nz + 2; wy = ny + 2; wx = nx + 2;
        bordered.assign(static_cast<size_t>(wz * wy * wx), 0);
        for (long z = 0; z < nz; ++z)
            for (long y = 0; y < ny; ++y)
                std::memcpy(bordered.data() + ((z + 1) * wy + y + 1) * wx + 1,
                            vol + z * plane + y * row, nx);
        t.v = bordered.data();
        t.border = 1;
    } else {
        t.v = vol;
        t.border = 0;
    }
    t.row = wx;
    t.plane = wy * wx;
    t.n_work = wz * wy * wx;
    for (int r = 0; r < 9; ++r)
        t.rowoff[r] = (r / 3 - 1) * t.plane + (r % 3 - 1) * t.row - 1;
    for (int k = 0; k < 26; ++k) {
        t.foff[k] = OFF[k][0] * t.plane + OFF[k][1] * t.row + OFF[k][2];
        for (int u = 0; u < OUT6_N[k]; ++u)
            t.out6[k][u] = OUT6[k][u][0] * t.plane + OUT6[k][u][1] * t.row
                + OUT6[k][u][2];
    }
    uint8_t* w = t.v;
    const long wplane = t.plane;
    const int max_level = t.max_level;

    // pass 2: the seeds (foreground with a background 6-neighbour), each
    // chunk of planes in scan order into its own lists per level; the
    // reads end before any pending bit is written
    t.buckets.resize(static_cast<size_t>(max_level) + 2);
    const int chunk = threaded ? 4 : std::max(nz, 1);
    const int n_chunks = (nz + chunk - 1) / chunk;
    std::vector<std::vector<std::vector<long>>> seeds(n_chunks);
#pragma omp parallel if (threaded)
    {
#pragma omp for schedule(dynamic, 1)
        for (int c = 0; c < n_chunks; ++c) {
            auto& lists = seeds[c];
            lists.resize(t.buckets.size());
            for (long z = static_cast<long>(c) * chunk;
                 z < std::min<long>(nz, (c + 1L) * chunk); ++z) {
                for (long y = 0; y < ny; ++y) {
                    const long r = (z + t.border) * wplane
                        + (y + t.border) * wx + t.border;
                    for (long x = 0; x < nx; ++x) {
                        if (!(x & 7) && x + 8 <= nx && !load8(w + r + x)) {
                            x += 7;
                            continue;
                        }
                        const long i = r + x;
                        if (!w[i] || !t.has_bg6(i)) continue;
                        lists[t.admission(i)].push_back(i);
                    }
                }
            }
        }
#pragma omp for schedule(dynamic, 1)
        for (int c = 0; c < n_chunks; ++c)
            for (const auto& list : seeds[c])
                for (long i : list) w[i] |= kPend;
    }
    // the buckets as one scan would fill them: chunk after chunk
    for (size_t lvl = 0; lvl < t.buckets.size(); ++lvl) {
        size_t total = 0;
        for (const auto& lists : seeds) total += lists[lvl].size();
        t.buckets[lvl].reserve(total);
        for (const auto& lists : seeds)
            t.buckets[lvl].insert(t.buckets[lvl].end(), lists[lvl].begin(),
                                  lists[lvl].end());
    }
    std::vector<std::vector<std::vector<long>>>().swap(seeds);
    t.queue.reserve(1 << 16);
    t.leftover.reserve(1 << 16);
    t.run();

    // the result as 0/1 bytes, back into vol
    if (on_face) {
#pragma omp parallel for schedule(static) if (threaded)
        for (long r = 0; r < static_cast<long>(nz) * ny; ++r) {
            const long z = r / ny, y = r % ny;
            const uint8_t* src = w + ((z + 1) * wy + y + 1) * wx + 1;
            uint8_t* dst = vol + r * nx;
            for (long x = 0; x < nx; ++x) dst[x] = src[x] & kFg;
        }
    } else {
        constexpr uint64_t kLow = 0x0101010101010101ULL;
        const long n8 = n & ~7L;
#pragma omp parallel for schedule(static) if (threaded)
        for (long i = 0; i < n8; i += 8) {
            const uint64_t v8 = load8(vol + i);
            if (!v8) continue;
            const uint64_t m = v8 & kLow;
            if (m != v8) std::memcpy(vol + i, &m, 8);
        }
        for (long i = n8; i < n; ++i) vol[i] &= kFg;
    }
    if (stats) {
        stats[0] = t.tests;
        stats[1] = t.deletions;
    }
    return t.deletions;
}

// sqrt of d (nz * ny rows of nx floats) in place, on the rows row_fg
// flags: elsewhere every element is 0, its own root
void sl_sqrt_rows(float* d, int nz, int ny, int nx, const uint8_t* row_fg,
                  int threaded) {
#pragma omp parallel for schedule(static) if (threaded)
    for (long r = 0; r < static_cast<long>(nz) * ny; ++r) {
        if (!row_fg[r]) continue;
        float* p = d + r * nx;
        for (int x = 0; x < nx; ++x) p[x] = std::sqrt(p[x]);
    }
}

// frame (nz, ny, nx) bool = 0, with the box skel (bz, by, bx; nonzero =
// on the skeleton) at (z0, y0, x0) as 0/1
void sl_frame(const uint8_t* skel, int bz, int by, int bx, int z0, int y0,
              int x0, uint8_t* frame, int nz, int ny, int nx,
              int threaded) {
    const long plane = static_cast<long>(ny) * nx;
#pragma omp parallel for schedule(static) if (threaded)
    for (int z = 0; z < nz; ++z) {
        uint8_t* fp = frame + z * plane;
        if (z < z0 || z >= z0 + bz) {
            std::memset(fp, 0, plane);
            continue;
        }
        const uint8_t* sp = skel + static_cast<long>(z - z0) * by * bx;
        std::memset(fp, 0, static_cast<long>(y0) * nx);
        for (int y = 0; y < by; ++y) {
            uint8_t* fr = fp + static_cast<long>(y0 + y) * nx;
            const uint8_t* sr = sp + static_cast<long>(y) * bx;
            std::memset(fr, 0, x0);
            for (int x = 0; x < bx; ++x) fr[x0 + x] = sr[x] != 0;
            std::memset(fr + x0 + bx, 0, nx - x0 - bx);
        }
        std::memset(fp + static_cast<long>(y0 + by) * nx, 0,
                    static_cast<long>(ny - y0 - by) * nx);
    }
}

}  // extern "C"
