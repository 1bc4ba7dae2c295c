// Native host-side image ops for the input pipeline.
//
// The reference's data path leans on OpenCV/skimage C++ kernels
// (warpAffine, fillConvexPoly — datasets/base_dataset.py). This library is
// the equivalent native component for the port's host pipeline (a copy of
// smirk_tpu/native/fastops.cpp, the same code): multi-channel bilinear and
// nearest affine warps, CLAHE and convex-polygon mask fill, exposed through
// a C ABI consumed via ctypes (smirk_tpu_torch/native/__init__.py). The
// numpy implementations in smirk_tpu_torch/data/transforms.py are the
// oracles; tests assert equivalence.
//
// Built at first use by smirk_tpu_torch/native/__init__.py (g++ -O3
// -march=native -ffp-contract=off -shared -fPIC -pthread).

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <atomic>
#include <functional>
#include <thread>
#include <vector>

// Work-stealing parallel-for over [0, n): the executor for the batched
// data-path ops below. Threads pull indices from a shared atomic counter, so
// uneven per-item cost (different hull sizes, cache effects) load-balances
// itself. n_threads <= 0 -> hardware concurrency.
static void run_parallel(int n, int n_threads,
                         const std::function<void(int)>& fn) {
    if (n_threads <= 0)
        n_threads = (int)std::thread::hardware_concurrency();
    n_threads = std::max(1, std::min(n_threads, n));
    if (n_threads == 1) {
        for (int i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<int> next(0);
    auto worker = [&]() {
        int i;
        while ((i = next.fetch_add(1)) < n) fn(i);
    };
    std::vector<std::thread> pool;
    pool.reserve(n_threads - 1);
    for (int t = 0; t < n_threads - 1; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
}

extern "C" {

// out(y, x, c) = img(iy, ix, c) bilinear, where (ix, iy) = Minv * (x, y, 1).
// img: (H, W, C) float32 row-major; minv: row-major 2x3 [ [a b tx], [c d ty] ]
// applied as ix = a*x + b*y + tx ; iy = c*x + d*y + ty.
void warp_affine_bilinear(const float* img, int H, int W, int C,
                          const double* minv, float* out, int OH, int OW) {
    const double a = minv[0], b = minv[1], tx = minv[2];
    const double c = minv[3], d = minv[4], ty = minv[5];
    for (int y = 0; y < OH; ++y) {
        const double base_x = b * y + tx;
        const double base_y = d * y + ty;
        float* orow = out + (size_t)y * OW * C;
        for (int x = 0; x < OW; ++x) {
            const double ix = a * x + base_x;
            const double iy = c * x + base_y;
            const int x0 = (int)std::floor(ix);
            const int y0 = (int)std::floor(iy);
            const double fx = ix - x0;
            const double fy = iy - y0;
            float* opix = orow + (size_t)x * C;
            if (x0 < -1 || y0 < -1 || x0 >= W || y0 >= H) {
                for (int ch = 0; ch < C; ++ch) opix[ch] = 0.0f;
                continue;
            }
            const int x1 = x0 + 1, y1 = y0 + 1;
            const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
            const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
            const double w00 = (1 - fx) * (1 - fy), w10 = fx * (1 - fy);
            const double w01 = (1 - fx) * fy, w11 = fx * fy;
            for (int ch = 0; ch < C; ++ch) {
                double v = 0.0;
                if (vx0 && vy0) v += w00 * img[((size_t)y0 * W + x0) * C + ch];
                if (vx1 && vy0) v += w10 * img[((size_t)y0 * W + x1) * C + ch];
                if (vx0 && vy1) v += w01 * img[((size_t)y1 * W + x0) * C + ch];
                if (vx1 && vy1) v += w11 * img[((size_t)y1 * W + x1) * C + ch];
                opix[ch] = (float)v;
            }
        }
    }
}

// Nearest-neighbor variant of the warp (mask channel in the augmentation
// pipeline, transforms.augment order=0): out(y,x,c) = img(rint(iy),
// rint(ix), c), zero outside. Rounding is floor(v + 0.5) to match the
// scipy order-0 spline semantics pinned by the numpy oracle.
void warp_affine_nearest(const float* img, int H, int W, int C,
                         const double* minv, float* out, int OH, int OW) {
    const double a = minv[0], b = minv[1], tx = minv[2];
    const double c = minv[3], d = minv[4], ty = minv[5];
    for (int y = 0; y < OH; ++y) {
        const double base_x = b * y + tx;
        const double base_y = d * y + ty;
        float* orow = out + (size_t)y * OW * C;
        for (int x = 0; x < OW; ++x) {
            const int ix = (int)std::floor(a * x + base_x + 0.5);
            const int iy = (int)std::floor(c * x + base_y + 0.5);
            float* opix = orow + (size_t)x * C;
            if (ix < 0 || iy < 0 || ix >= W || iy >= H) {
                for (int ch = 0; ch < C; ++ch) opix[ch] = 0.0f;
            } else {
                const float* ipix = img + ((size_t)iy * W + ix) * C;
                for (int ch = 0; ch < C; ++ch) opix[ch] = ipix[ch];
            }
        }
    }
}

// CLAHE over a u8 single-channel image (the LAB L channel in
// transforms._clahe). Algorithm follows the OpenCV CLAHE semantics the
// reference's albumentations pipeline uses (per-tile 256-bin histogram,
// integer clip limit scaled by tile area, batch+residual-step excess
// redistribution, bilinear interpolation between the 4 surrounding tile
// LUTs); the numpy oracle in transforms.py is the equivalence reference.
// Non-divisible sizes pad right/bottom by reflect-101 like cv2.

// reflect-101 index fold valid for ANY n (repeated reflection, like
// np.pad mode="reflect"), not just n < 2*(N-1): needed when the pad
// width exceeds the image extent (H or W smaller than the tile grid).
static inline int reflect101(int n, int N) {
    if (N == 1) return 0;
    const int period = 2 * (N - 1);
    n %= period;
    if (n < 0) n += period;
    return n < N ? n : period - n;
}

static void clahe_u8_impl(const uint8_t* in, int H, int W, double clip_limit,
                          int tiles_x, int tiles_y, uint8_t* out) {
    const bool divisible = (W % tiles_x == 0) && (H % tiles_y == 0);
    int PW = W, PH = H;
    std::vector<uint8_t> padded;
    const uint8_t* src = in;
    if (!divisible) {
        PW = W + (tiles_x - W % tiles_x);
        PH = H + (tiles_y - H % tiles_y);
        padded.resize((size_t)PH * PW);
        for (int y = 0; y < PH; ++y) {
            const int sy = y < H ? y : reflect101(y, H);
            for (int x = 0; x < PW; ++x) {
                const int sx = x < W ? x : reflect101(x, W);
                padded[(size_t)y * PW + x] = in[(size_t)sy * W + sx];
            }
        }
        src = padded.data();
    }
    const int tw = PW / tiles_x, th = PH / tiles_y;
    const int tile_area = tw * th;
    int clip = 0;
    if (clip_limit > 0.0)
        clip = std::max(1, (int)(clip_limit * tile_area / 256.0));

    std::vector<uint8_t> lut((size_t)tiles_y * tiles_x * 256);
    std::vector<int> hist(256);
    const double lut_scale = 255.0 / tile_area;
    for (int tyi = 0; tyi < tiles_y; ++tyi) {
        for (int txi = 0; txi < tiles_x; ++txi) {
            std::fill(hist.begin(), hist.end(), 0);
            for (int y = tyi * th; y < (tyi + 1) * th; ++y)
                for (int x = txi * tw; x < (txi + 1) * tw; ++x)
                    hist[src[(size_t)y * PW + x]]++;
            if (clip > 0) {
                int clipped = 0;
                for (int i = 0; i < 256; ++i)
                    if (hist[i] > clip) { clipped += hist[i] - clip; hist[i] = clip; }
                const int batch = clipped / 256;
                int residual = clipped - batch * 256;
                for (int i = 0; i < 256; ++i) hist[i] += batch;
                if (residual > 0) {
                    const int step = std::max(1, 256 / residual);
                    for (int i = 0; i < 256 && residual > 0; i += step, --residual)
                        hist[i]++;
                }
            }
            uint8_t* tlut = lut.data() + ((size_t)tyi * tiles_x + txi) * 256;
            long long sum = 0;
            for (int i = 0; i < 256; ++i) {
                sum += hist[i];
                const long v = std::lrint(sum * lut_scale);
                tlut[i] = (uint8_t)std::min(255L, std::max(0L, v));
            }
        }
    }

    const double inv_tw = 1.0 / tw, inv_th = 1.0 / th;
    for (int y = 0; y < H; ++y) {
        const double tyf = y * inv_th - 0.5;
        int ty1 = (int)std::floor(tyf);
        const double ya = tyf - ty1;
        int ty2 = std::min(ty1 + 1, tiles_y - 1);
        ty1 = std::max(ty1, 0);
        for (int x = 0; x < W; ++x) {
            const double txf = x * inv_tw - 0.5;
            int tx1 = (int)std::floor(txf);
            const double xa = txf - tx1;
            int tx2 = std::min(tx1 + 1, tiles_x - 1);
            tx1 = std::max(tx1, 0);
            const uint8_t v = in[(size_t)y * W + x];
            const double l11 = lut[((size_t)ty1 * tiles_x + tx1) * 256 + v];
            const double l12 = lut[((size_t)ty1 * tiles_x + tx2) * 256 + v];
            const double l21 = lut[((size_t)ty2 * tiles_x + tx1) * 256 + v];
            const double l22 = lut[((size_t)ty2 * tiles_x + tx2) * 256 + v];
            const double res = (l11 * (1 - xa) + l12 * xa) * (1 - ya) +
                               (l21 * (1 - xa) + l22 * xa) * ya;
            const long r = std::lrint(res);
            out[(size_t)y * W + x] = (uint8_t)std::min(255L, std::max(0L, r));
        }
    }
}

void clahe_u8(const uint8_t* in, int H, int W, double clip_limit,
              int tiles_x, int tiles_y, uint8_t* out) {
    clahe_u8_impl(in, H, W, clip_limit, tiles_x, tiles_y, out);
}

// Full CLAHE augmentation op over a float32 sRGB image in [0,1]
// (transforms._clahe hot path): u8-quantize, sRGB->LAB (D65, gamma — the
// cv2 COLOR_RGB2LAB semantics, float math instead of cv2's fixed-point
// tables), CLAHE on the L channel, LAB->sRGB, u8-quantize. The numpy
// fallback in transforms._clahe mirrors this pipeline.
void clahe_rgb_f32(const float* img, int H, int W, double clip_limit,
                   int tiles_x, int tiles_y, float* out) {
    static const double M[9] = {0.412453, 0.357580, 0.180423,
                                0.212671, 0.715160, 0.072169,
                                0.019334, 0.119193, 0.950227};
    // inverse of M (adjugate/det, double)
    double inv[9];
    {
        const double a = M[0], b = M[1], c = M[2], d = M[3], e = M[4],
                     f = M[5], g = M[6], h = M[7], i = M[8];
        const double det = a * (e * i - f * h) - b * (d * i - f * g) +
                           c * (d * h - e * g);
        inv[0] = (e * i - f * h) / det; inv[1] = (c * h - b * i) / det;
        inv[2] = (b * f - c * e) / det; inv[3] = (f * g - d * i) / det;
        inv[4] = (a * i - c * g) / det; inv[5] = (c * d - a * f) / det;
        inv[6] = (d * h - e * g) / det; inv[7] = (b * g - a * h) / det;
        inv[8] = (a * e - b * d) / det;
    }
    const double eps = 0.008856, kappa = 903.3;
    // u8 -> linear decode table (input is quantized to 256 sRGB levels,
    // like the reference's u8 albumentations pipeline); magic-static init
    // is thread-safe under the loader's worker threads
    static const std::vector<double> lin_lut = [] {
        std::vector<double> t(256);
        for (int v = 0; v < 256; ++v) {
            const double c = v / 255.0;
            t[v] = c <= 0.04045 ? c / 12.92
                                : std::pow((c + 0.055) / 1.055, 2.4);
        }
        return t;
    }();

    // sRGB-encode via threshold table instead of per-pixel pow: output
    // level q = #{v : thr[v] <= lin}, where thr[v] is the linear value at
    // which round(encode(lin)*255) crosses from v-1 to v.
    static const std::vector<double> enc_thr = [] {
        std::vector<double> t(255);
        for (int v = 1; v <= 255; ++v) {
            const double s = (v - 0.5) / 255.0;
            t[v - 1] = s <= 0.04045 ? s / 12.92
                                    : std::pow((s + 0.055) / 1.055, 2.4);
        }
        return t;
    }();

    const size_t n = (size_t)H * W;
    std::vector<uint8_t> l_u8(n);
    std::vector<float> av(n), bv(n);
    auto fl = [&](double t) {
        return t > eps ? std::cbrt(t) : 7.787 * t + 16.0 / 116.0;
    };
    run_parallel(H, 0, [&](int row) {
      for (size_t p = (size_t)row * W; p < (size_t)(row + 1) * W; ++p) {
        const float* px = img + p * 3;
        int r = (int)std::lrintf(px[0] * 255.0f);
        int g = (int)std::lrintf(px[1] * 255.0f);
        int b = (int)std::lrintf(px[2] * 255.0f);
        r = std::min(255, std::max(0, r));
        g = std::min(255, std::max(0, g));
        b = std::min(255, std::max(0, b));
        const double R = lin_lut[r], G = lin_lut[g], B = lin_lut[b];
        const double X = (M[0] * R + M[1] * G + M[2] * B) / 0.950456;
        const double Y = M[3] * R + M[4] * G + M[5] * B;
        const double Z = (M[6] * R + M[7] * G + M[8] * B) / 1.088754;
        const double fx = fl(X), fy = fl(Y), fz = fl(Z);
        const double L = Y > eps ? 116.0 * fy - 16.0 : kappa * Y;
        const long lq = std::lrint(L * (255.0 / 100.0));
        l_u8[p] = (uint8_t)std::min(255L, std::max(0L, lq));
        av[p] = (float)(500.0 * (fx - fy));
        bv[p] = (float)(200.0 * (fy - fz));
      }
    });

    std::vector<uint8_t> l_eq(n);
    clahe_u8_impl(l_u8.data(), H, W, clip_limit, tiles_x, tiles_y,
                  l_eq.data());

    auto finv = [&](double f) {
        const double f3 = f * f * f;
        return f3 > eps ? f3 : (f - 16.0 / 116.0) / 7.787;
    };
    run_parallel(H, 0, [&](int row) {
      for (size_t p = (size_t)row * W; p < (size_t)(row + 1) * W; ++p) {
        const double L = l_eq[p] * (100.0 / 255.0);
        const double fy = (L + 16.0) / 116.0;
        const double fx = fy + av[p] / 500.0;
        const double fz = fy - bv[p] / 200.0;
        const double yr = L > kappa * eps ? fy * fy * fy : L / kappa;
        const double X = finv(fx) * 0.950456, Z = finv(fz) * 1.088754;
        float* opx = out + p * 3;
        for (int ch = 0; ch < 3; ++ch) {
            double lin = inv[3 * ch] * X + inv[3 * ch + 1] * yr +
                         inv[3 * ch + 2] * Z;
            lin = std::min(1.0, std::max(0.0, lin));
            const int q = (int)(std::upper_bound(enc_thr.begin(),
                                                 enc_thr.end(), lin) -
                                enc_thr.begin());
            opx[ch] = (float)(q / 255.0);
        }
      }
    });
}

// mask(y, x) = 0 inside the convex hull of pts, 1 outside.
// pts: (N, 2) float64 [x, y]. Scanline fill over the hull polygon.
void convex_hull_mask(const double* pts, int N, float* mask, int H, int W) {
    std::fill(mask, mask + (size_t)H * W, 1.0f);
    if (N < 3) return;

    // Andrew's monotone chain.
    std::vector<std::pair<double, double>> p(N);
    for (int i = 0; i < N; ++i) p[i] = {pts[2 * i], pts[2 * i + 1]};
    std::sort(p.begin(), p.end());
    p.erase(std::unique(p.begin(), p.end()), p.end());
    const int n = (int)p.size();
    if (n < 3) return;
    auto cross = [](const std::pair<double, double>& o,
                    const std::pair<double, double>& a,
                    const std::pair<double, double>& b) {
        return (a.first - o.first) * (b.second - o.second) -
               (a.second - o.second) * (b.first - o.first);
    };
    std::vector<std::pair<double, double>> hull(2 * n);
    int k = 0;
    for (int i = 0; i < n; ++i) {
        while (k >= 2 && cross(hull[k - 2], hull[k - 1], p[i]) <= 0) k--;
        hull[k++] = p[i];
    }
    for (int i = n - 2, t = k + 1; i >= 0; i--) {
        while (k >= t && cross(hull[k - 2], hull[k - 1], p[i]) <= 0) k--;
        hull[k++] = p[i];
    }
    hull.resize(k - 1);
    const int hn = (int)hull.size();

    // Half-plane scanline: for each row, x-interval inside all edges.
    for (int y = 0; y < H; ++y) {
        double lo = 0.0, hi = (double)W - 1.0;
        bool empty = false;
        for (int i = 0; i < hn && !empty; ++i) {
            const double x0 = hull[i].first, y0 = hull[i].second;
            const double x1 = hull[(i + 1) % hn].first,
                         y1 = hull[(i + 1) % hn].second;
            // CCW hull: inside iff (edge) x (point) >= 0, i.e.
            // (x1-x0)*(y-y0) - (y1-y0)*(x-x0) >= 0  ->  A*x + B >= 0
            const double A = y0 - y1;
            const double B = (x1 - x0) * (y - y0) + x0 * (y1 - y0);
            // A*x + B >= 0
            if (std::abs(A) < 1e-12) {
                if (B < 0) empty = true;
            } else if (A > 0) {
                lo = std::max(lo, -B / A);
            } else {
                hi = std::min(hi, -B / A);
            }
        }
        if (empty) continue;
        const int xs = (int)std::ceil(lo - 1e-9);
        const int xe = (int)std::floor(hi + 1e-9);
        for (int x = std::max(0, xs); x <= std::min(W - 1, xe); ++x)
            mask[(size_t)y * W + x] = 0.0f;
    }
}

// Batched variants over the thread pool: the native data-path executor for
// chunked host pipelines (video demo crops a whole device batch at once).
// imgs: (N, H, W, C) contiguous; minvs: (N, 6); out: (N, OH, OW, C).
void warp_affine_batch(const float* imgs, int H, int W, int C,
                       const double* minvs, float* out, int OH, int OW,
                       int N, int n_threads) {
    const size_t in_stride = (size_t)H * W * C;
    const size_t out_stride = (size_t)OH * OW * C;
    run_parallel(N, n_threads, [&](int i) {
        warp_affine_bilinear(imgs + (size_t)i * in_stride, H, W, C,
                             minvs + (size_t)i * 6,
                             out + (size_t)i * out_stride, OH, OW);
    });
}

// pts: (N, K, 2) float64; masks: (N, H, W) float32.
void convex_hull_mask_batch(const double* pts, int K, float* masks, int H,
                            int W, int N, int n_threads) {
    const size_t mask_stride = (size_t)H * W;
    run_parallel(N, n_threads, [&](int i) {
        convex_hull_mask(pts + (size_t)i * K * 2, K,
                         masks + (size_t)i * mask_stride, H, W);
    });
}

}  // extern "C"
