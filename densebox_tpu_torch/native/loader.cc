// Native data-loader core of the port (its own copy of
// densebox_tpu/native/loader.cc). A GIL-free thread pool that decodes,
// resizes and canvas-pads a whole batch of images directly into the
// caller's buffer (a pinned host tensor when the batch goes to the card).
// Python keeps annotation parsing and queueing
// (densebox_tpu_torch/data/pipeline.py).
//
// Semantics mirror data/pipeline.py::canvas_batch exactly:
//   * imread COLOR (BGR) -> RGB
//   * float32, divided by 255.0f (division, not 1/255 multiply — keeps
//     the result bit-identical to numpy's `img.astype(f32) / 255.0`)
//   * f = min(1, hc/h, wc/w) in double; INTER_AREA resize to
//     (int(w*f), int(h*f)) when f < 1, applied to the normalized f32
//     image (same operation order as the Python path)
//   * top-left placement on a zeroed (hc, wc, 3) canvas
//
// C ABI only (consumed via ctypes).

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// status codes per image
enum : int { kOk = 0, kReadFailed = 1, kBadImage = 2 };

void load_one(const char* path, int hc, int wc, float* out_img,
              float* out_scale, int* out_status) {
  cv::Mat bgr = cv::imread(path, cv::IMREAD_COLOR);
  if (bgr.empty()) {
    *out_status = kReadFailed;
    return;
  }
  cv::Mat rgb;
  cv::cvtColor(bgr, rgb, cv::COLOR_BGR2RGB);
  cv::Mat f32;
  rgb.convertTo(f32, CV_32FC3);          // exact int -> float
  // per-element IEEE division (cv::Mat::operator/= multiplies by the
  // reciprocal and lands 1 ulp off numpy's `img / 255.0` on ~25% of
  // values — measured); explicit divss matches numpy bitwise
  for (int r = 0; r < f32.rows; ++r) {
    float* p = f32.ptr<float>(r);
    const int nvals = f32.cols * 3;
    for (int c = 0; c < nvals; ++c) p[c] = p[c] / 255.0f;
  }

  int h = f32.rows, w = f32.cols;
  double f = 1.0;
  if (h > hc || w > wc) {
    f = std::min(1.0, std::min(static_cast<double>(hc) / h,
                               static_cast<double>(wc) / w));
    cv::Mat small;
    cv::resize(f32, small,
               cv::Size(static_cast<int>(w * f), static_cast<int>(h * f)),
               0, 0, cv::INTER_AREA);
    f32 = small;
    h = f32.rows;
    w = f32.cols;
  }
  if (h > hc || w > wc) {                // defensive: rounding overshoot
    *out_status = kBadImage;
    return;
  }
  // canvas rows are wc*3 floats; copy the image row block
  for (int r = 0; r < h; ++r) {
    std::memcpy(out_img + static_cast<size_t>(r) * wc * 3,
                f32.ptr<float>(r), static_cast<size_t>(w) * 3 * sizeof(float));
  }
  *out_scale = static_cast<float>(f);
  *out_status = kOk;
}

}  // namespace

extern "C" {

// Decode + normalize + resize-to-fit + canvas-pad `n` images in parallel.
// `out` must be a zero-initialized (n, hc, wc, 3) float32 buffer;
// `scales` (n,) float32; `status` (n,) int32. Returns the number of
// images that failed (0 = all good); per-image codes land in `status`.
int densebox_load_canvas(const char** paths, int n, int hc, int wc,
                         float* out, float* scales, int* status,
                         int num_threads) {
  if (n <= 0) return 0;
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  num_threads = std::min(num_threads, n);
  const size_t img_stride = static_cast<size_t>(hc) * wc * 3;

  std::atomic<int> next(0);
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        scales[i] = 1.0f;
        // an exception escaping a std::thread lambda is std::terminate —
        // a degenerate image (e.g. resize to a 0-dim dsize) must come
        // back as a per-image status the Python side can raise, exactly
        // like the Python backend's cv2.error
        try {
          load_one(paths[i], hc, wc, out + img_stride * i, &scales[i],
                   &status[i]);
        } catch (...) {
          status[i] = kBadImage;
        }
      }
    });
  }
  for (auto& w : workers) w.join();

  int failures = 0;
  for (int i = 0; i < n; ++i) failures += (status[i] != kOk);
  return failures;
}

// Version/ABI tag so the Python side can assert compatibility.
int densebox_loader_abi_version() { return 1; }

}  // extern "C"
