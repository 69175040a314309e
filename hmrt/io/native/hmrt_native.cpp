// Native I/O runtime for hmrt (SURVEY.md C4/C5, native tier).
//
// The reference's host runtime is C++ (image loading, buffer management);
// this build keeps the compute path in XLA/Pallas and implements the
// host-side I/O hot spots natively:
//   - PNG decode (zlib inflate + scanline unfilter): the pure-Python
//     fallback unfilters row-by-row in the interpreter, minutes for an
//     8192^2 DEM; this does it at memory speed.
//   - mmap'd raw-f32 tile extraction: stream rectangular tiles out of
//     huge heightmaps without materializing the whole grid (C5).
//   - host max-mip pyramid build: for CPU-side tools/tests.
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// Unfilter PNG scanlines in place-ish: raw = h*(1+stride) filtered bytes,
// out = h*stride. Returns 0 on success.
int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t stride,
                 int bpp) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; y++) {
        uint8_t ft = raw[y * (stride + 1)];
        const uint8_t* line = raw + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        switch (ft) {
            case 0:
                memcpy(cur, line, stride);
                break;
            case 1:
                for (int64_t i = 0; i < stride; i++) {
                    uint8_t a = i >= bpp ? cur[i - bpp] : 0;
                    cur[i] = (uint8_t)(line[i] + a);
                }
                break;
            case 2:
                for (int64_t i = 0; i < stride; i++) {
                    uint8_t b = prev ? prev[i] : 0;
                    cur[i] = (uint8_t)(line[i] + b);
                }
                break;
            case 3:
                for (int64_t i = 0; i < stride; i++) {
                    int a = i >= bpp ? cur[i - bpp] : 0;
                    int b = prev ? prev[i] : 0;
                    cur[i] = (uint8_t)(line[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; i++) {
                    int a = i >= bpp ? cur[i - bpp] : 0;
                    int b = prev ? prev[i] : 0;
                    int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    cur[i] = (uint8_t)(line[i] + paeth(a, b, c));
                }
                break;
            default:
                return -1;
        }
        prev = cur;
    }
    return 0;
}

// zlib inflate of a full buffer. Returns decompressed size or <0 on error.
int64_t zlib_inflate(const uint8_t* src, int64_t src_len, uint8_t* dst,
                     int64_t dst_cap) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return -1;
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = (uInt)src_len;
    zs.next_out = dst;
    zs.avail_out = (uInt)dst_cap;
    int rc = inflate(&zs, Z_FINISH);
    int64_t got = (int64_t)zs.total_out;
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) return -2;
    return got;
}

// ---------------------------------------------------------------------------
// mmap'd raw-f32 tile reader (C5: tiled heightmap support)
// ---------------------------------------------------------------------------

struct RawMap {
    int fd;
    int64_t n;       // square side
    float* data;     // mmap'd
    int64_t bytes;
};

void* rawmap_open(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    int64_t count = st.st_size / (int64_t)sizeof(float);
    int64_t n = (int64_t)(sqrtl((long double)count) + 0.5L);
    if (n * n != count) { close(fd); return nullptr; }
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) { close(fd); return nullptr; }
    RawMap* m = new RawMap{fd, n, (float*)p, (int64_t)st.st_size};
    return m;
}

int64_t rawmap_side(void* handle) { return ((RawMap*)handle)->n; }

// Copy tile [y0:y0+th, x0:x0+tw] into out (row-major th*tw), edge-clamped.
int rawmap_tile(void* handle, int64_t y0, int64_t x0, int64_t th, int64_t tw,
                float* out) {
    RawMap* m = (RawMap*)handle;
    for (int64_t y = 0; y < th; y++) {
        int64_t sy = std::min(std::max(y0 + y, (int64_t)0), m->n - 1);
        const float* src = m->data + sy * m->n;
        for (int64_t x = 0; x < tw; x++) {
            int64_t sx = std::min(std::max(x0 + x, (int64_t)0), m->n - 1);
            out[y * tw + x] = src[sx];
        }
    }
    return 0;
}

void rawmap_close(void* handle) {
    RawMap* m = (RawMap*)handle;
    munmap(m->data, m->bytes);
    close(m->fd);
    delete m;
}

// ---------------------------------------------------------------------------
// Host max-mip pyramid build (SURVEY.md C6, host-side twin)
// ---------------------------------------------------------------------------

// heights: n*n corner samples. out: flat level-major pyramid over the
// m*m padded cell grid (m = next pow2 of n-1), exactly the device layout
// (core/pyramid.py). out must hold (4*m*m-1)/3 floats. Returns m.
int64_t build_pyramid_host(const float* heights, int64_t n, float* out,
                           float neg_inf) {
    int64_t nc = n - 1;
    int64_t m = 1;
    while (m < nc) m <<= 1;
    // level 0: cell maxes, padded
    for (int64_t y = 0; y < m; y++) {
        for (int64_t x = 0; x < m; x++) {
            float v = neg_inf;
            if (y < nc && x < nc) {
                float a = heights[y * n + x];
                float b = heights[y * n + x + 1];
                float c = heights[(y + 1) * n + x];
                float d = heights[(y + 1) * n + x + 1];
                v = std::max(std::max(a, b), std::max(c, d));
            }
            out[y * m + x] = v;
        }
    }
    float* prev = out;
    int64_t side = m;
    float* cur = out + m * m;
    while (side > 1) {
        int64_t half = side >> 1;
        for (int64_t y = 0; y < half; y++)
            for (int64_t x = 0; x < half; x++) {
                float a = prev[(2 * y) * side + 2 * x];
                float b = prev[(2 * y) * side + 2 * x + 1];
                float c = prev[(2 * y + 1) * side + 2 * x];
                float d = prev[(2 * y + 1) * side + 2 * x + 1];
                cur[y * half + x] = std::max(std::max(a, b), std::max(c, d));
            }
        prev = cur;
        cur += half * half;
        side = half;
    }
    return m;
}

// fBm value-noise terrain accumulation, BIT-IDENTICAL to the numpy path
// in io/heightmap.py (procedural_terrain / _value_noise_grid): the
// random octave grids are drawn in Python (tiny), this evaluates the
// bicubic-smoothstep interpolation + ridge + amp accumulation per pixel
// with the exact same operation order and PRECISION as numpy —
// `f = t - i` is float32 minus int32, which numpy promotes to float64,
// so the whole interpolation runs in double and rounds to float32 once
// per octave at the `acc += amp * layer` in-place add. Parallel over
// rows. grids is the octave grids concatenated flat; offs[o] indexes
// octave o's (cells[o]+1)^2 grid; amps are the float64 octave weights.
// Returns 0. Build must use -ffp-contract=off (no FMA re-rounding).
int terrain_fbm(const float* grids, const int64_t* offs,
                const int64_t* cells_arr, const double* amps,
                int64_t octaves, int64_t n, int ridged, float* out) {
    // plain std::thread row-parallelism. (OpenMP was originally blamed
    // for full-suite XLA compile segfaults; the real cause turned out to
    // be vm.max_map_count exhaustion by accumulated XLA:CPU JIT
    // mappings — see tests/conftest.py _bound_jit_maps. std::thread is
    // kept anyway: it avoids shipping a second threading runtime.)
    auto rows = [&](int64_t ybeg, int64_t yend) {
    for (int64_t y = ybeg; y < yend; y++) {
        float* row = out + y * n;
        for (int64_t x = 0; x < n; x++) row[x] = 0.0f;
        for (int64_t o = 0; o < octaves; o++) {
            const float* g = grids + offs[o];
            const int64_t c = cells_arr[o];
            const int64_t stride = c + 1;
            // np.linspace(0, c, n, endpoint=False, dtype=f32) computes
            // arange(n) * (c/n) in f64 then casts — reproduced exactly
            const double delta = (double)c / (double)n;
            const float ty = (float)((double)y * delta);
            int64_t iy = (int64_t)ty;
            if (iy > c - 1) iy = c - 1;
            const double fy = (double)ty - (double)iy;
            const double sy = fy * fy * (3.0 - 2.0 * fy);
            const double omsy = 1.0 - sy;
            const float* g0 = g + iy * stride;
            const float* g1 = g + (iy + 1) * stride;
            const double amp = amps[o];
            for (int64_t x = 0; x < n; x++) {
                const float tx = (float)((double)x * delta);
                int64_t ix = (int64_t)tx;
                if (ix > c - 1) ix = c - 1;
                const double fx = (double)tx - (double)ix;
                const double sx = fx * fx * (3.0 - 2.0 * fx);
                const double omsx = 1.0 - sx;
                // numpy's elementwise order:
                // ((g00*(1-sy))*(1-sx) + (g10*sy)*(1-sx)) + (g01*(1-sy))*sx
                //   + (g11*sy)*sx, additions left-associated, in float64
                const double t1 = ((double)g0[ix] * omsy) * omsx;
                const double t2 = ((double)g1[ix] * sy) * omsx;
                const double t3 = ((double)g0[ix + 1] * omsy) * sx;
                const double t4 = ((double)g1[ix + 1] * sy) * sx;
                double v = ((t1 + t2) + t3) + t4;
                if (ridged) v = 1.0 - fabs(v);
                // numpy's in-place `acc += amp * layer`: rhs in f64,
                // accumulate in f64, store rounded to f32
                row[x] = (float)((double)row[x] + amp * v);
            }
        }
    }
    };  // rows lambda
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads = (int64_t)std::min<unsigned>(hw ? hw : 1, 16);
    nthreads = std::max<int64_t>(1, std::min(nthreads, n));
    if (nthreads == 1 || n < 256) {
        rows(0, n);
        return 0;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; t++) {
        int64_t y0 = t * chunk, y1 = std::min(n, y0 + chunk);
        if (y0 >= y1) break;
        pool.emplace_back(rows, y0, y1);
    }
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
