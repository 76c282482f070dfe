// hockey_host: the host ByteTrack's association kernels, a C ABI loaded
// with ctypes by tracking/native.py, which builds this file at first use.
//
// Port of native/hockey_host.cpp (`iou_matrix`, `solve_lsap`) with the
// same arithmetic and the same loop order, so that the assignment the
// solver picks among tied optima is the JAX package's:
//
//   - iou_matrix: pairwise IoU of two xyxy box sets, 0 where the union is
//                 at most 1e-9;
//   - solve_lsap: rectangular linear sum assignment (Jonker-Volgenant
//                 shortest augmenting path with potentials, O(n^2 m)),
//                 used by ByteTrack's two association stages.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 hockey_host.cpp
//            -o libhockey_host.so

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// a: n x 4, b: m x 4 (xyxy), out: n x m row-major.
void iou_matrix(const float* a, int32_t n, const float* b, int32_t m,
                float* out) {
  std::vector<float> area_b(m);
  for (int32_t j = 0; j < m; ++j) {
    const float* q = b + 4 * j;
    area_b[j] = (q[2] - q[0]) * (q[3] - q[1]);
  }
  for (int32_t i = 0; i < n; ++i) {
    const float* p = a + 4 * i;
    const float area_a = (p[2] - p[0]) * (p[3] - p[1]);
    float* row = out + (int64_t)i * m;
    for (int32_t j = 0; j < m; ++j) {
      const float* q = b + 4 * j;
      const float x1 = p[0] > q[0] ? p[0] : q[0];
      const float y1 = p[1] > q[1] ? p[1] : q[1];
      const float x2 = p[2] < q[2] ? p[2] : q[2];
      const float y2 = p[3] < q[3] ? p[3] : q[3];
      const float w = x2 - x1 > 0.f ? x2 - x1 : 0.f;
      const float h = y2 - y1 > 0.f ? y2 - y1 : 0.f;
      const float inter = w * h;
      const float uni = area_a + area_b[j] - inter;
      row[j] = uni > 1e-9f ? inter / uni : 0.f;
    }
  }
}

// Rectangular linear sum assignment (minimize cost). cost: n x m row-major,
// n <= m (the caller transposes otherwise). row_to_col[i] = the column of
// row i. Returns 0 on success, -1 for n > m, -2 when no column can be
// reached (non-finite costs).
int32_t solve_lsap(const double* cost, int32_t n, int32_t m,
                   int32_t* row_to_col) {
  if (n == 0) return 0;
  if (n > m) return -1;

  // 1-indexed; p[j] = row matched to column j (0 = none).
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int32_t> p(m + 1, 0), way(m + 1, 0);

  for (int32_t i = 1; i <= n; ++i) {
    p[0] = i;
    int32_t j0 = 0;
    std::vector<double> minv(m + 1, DBL_MAX);
    std::vector<bool> used(m + 1, false);
    do {
      used[j0] = true;
      const int32_t i0 = p[j0];
      double delta = DBL_MAX;
      int32_t j1 = -1;
      for (int32_t j = 1; j <= m; ++j) {
        if (used[j]) continue;
        const double cur =
            cost[(int64_t)(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      if (j1 == -1) return -2;
      for (int32_t j = 0; j <= m; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    // augment along the alternating path
    do {
      const int32_t j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0 != 0);
  }

  for (int32_t i = 0; i < n; ++i) row_to_col[i] = -1;
  for (int32_t j = 1; j <= m; ++j) {
    if (p[j] > 0) row_to_col[p[j] - 1] = j - 1;
  }
  return 0;
}

}  // extern "C"
