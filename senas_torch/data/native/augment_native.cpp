// Curvature-flow denoising of the PROMISE12 cache build, in C++ behind a
// plain C interface (loaded with ctypes).
//
// A copy of the curvature_flow of senas_tpu/data/native/augment_native.cpp
// (the only function of that library the data path calls). The reference
// delegates this to SimpleITK's CurvatureFlow (promise12.py:269,
// augmentation.py:428-442); numpy's version is senas_torch/data/augment.py
// `_curvature_flow`, and the two agree exactly.
//
// Built at first use by senas_torch/data/native/build.py (g++ -O3 -shared
// -fPIC -std=c++17).

#include <algorithm>
#include <cstring>
#include <vector>

extern "C" {

// dI/dt = kappa * |grad I| with central-difference curvature,
// edge-replicated boundary. In place over a [h, w] float64 image.
void curvature_flow(double* u, int h, int w, double t_step, int n_iter) {
    const double eps = 1e-8;
    std::vector<double> next(static_cast<size_t>(h) * w);
    auto at = [&](const double* buf, int y, int x) {
        y = std::min(std::max(y, 0), h - 1);
        x = std::min(std::max(x, 0), w - 1);
        return buf[static_cast<size_t>(y) * w + x];
    };
    for (int it = 0; it < n_iter; ++it) {
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                const double c = at(u, y, x);
                const double xm = at(u, y, x - 1), xp = at(u, y, x + 1);
                const double ym = at(u, y - 1, x), yp = at(u, y + 1, x);
                const double ux = (xp - xm) / 2.0;
                const double uy = (yp - ym) / 2.0;
                const double uxx = xp - 2.0 * c + xm;
                const double uyy = yp - 2.0 * c + ym;
                const double uxy = (at(u, y + 1, x + 1) - at(u, y + 1, x - 1)
                                    - at(u, y - 1, x + 1) + at(u, y - 1, x - 1))
                                   / 4.0;
                const double num = uxx * uy * uy - 2.0 * ux * uy * uxy
                                   + uyy * ux * ux;
                const double den = ux * ux + uy * uy + eps;
                next[static_cast<size_t>(y) * w + x] = c + t_step * num / den;
            }
        }
        std::memcpy(u, next.data(), sizeof(double) * next.size());
    }
}

}  // extern "C"
