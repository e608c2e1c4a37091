// raybatch: host-side training-batch assembly for pvd_tpu_torch.
//
// A copy of the JAX package's native/raybatch.cpp, kept by the port so it
// shares no file with that package: a multithreaded producer of (image
// index, pixel indices, ground-truth RGB[A]) batches over a preloaded image
// cache, each thread drawing from its own PCG32 stream into a bounded
// queue, so host-side batch assembly runs ahead of the device step loop.
// With one thread the batches are a deterministic function of the seed,
// the same as the JAX package's library gives.
//
// A C ABI for ctypes:
//   rb_create(images, n_images, h, w, channels, n_rays, seed, queue_depth,
//             n_threads)
//   rb_next(handle, out_inds[n_rays], out_pix[n_rays*ch]) -> image index
//   rb_destroy(handle)
//
// Built at first use by pvd_tpu_torch/data/raybatch.py
// (g++ -O3 -shared -fPIC -pthread -std=c++17).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// pcg32 — minimal PCG XSH RR 64/32 generator (same family the reference's
// marching kernels use for perturbation; O'Neill 2014, public domain).
struct Pcg32 {
  uint64_t state = 0x853c49e6748fea9bULL;
  uint64_t inc = 0xda3e39cb94b95bdbULL;
  void seed(uint64_t initstate, uint64_t initseq) {
    state = 0u;
    inc = (initseq << 1u) | 1u;
    next();
    state += initstate;
    next();
  }
  uint32_t next() {
    uint64_t old = state;
    state = old * 6364136223846793005ULL + inc;
    uint32_t xorshifted = static_cast<uint32_t>(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = static_cast<uint32_t>(old >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((-rot) & 31));
  }
  uint32_t bounded(uint32_t bound) {
    // Lemire-style rejection-free enough for sampling pixels
    return static_cast<uint32_t>((static_cast<uint64_t>(next()) * bound) >> 32);
  }
  float uniform() { return (next() >> 8) * (1.0f / 16777216.0f); }
};

struct Batch {
  int32_t img_index = 0;
  std::vector<int32_t> inds;
  std::vector<float> pix;
};

struct RayBatcher {
  const float* images = nullptr;  // [n_images, h*w, channels], row-major
  int n_images = 0, hw = 0, channels = 0, n_rays = 0;
  size_t queue_depth = 4;

  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_producer, cv_consumer;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  Pcg32 img_rng;

  void producer(uint64_t seed, int worker_id) {
    Pcg32 rng;
    rng.seed(seed, 0x9e3779b97f4a7c15ULL * (worker_id + 1));
    while (!stop.load(std::memory_order_relaxed)) {
      Batch b;
      b.img_index = static_cast<int32_t>(rng.bounded(n_images));
      b.inds.resize(n_rays);
      b.pix.resize(static_cast<size_t>(n_rays) * channels);
      const float* img =
          images + static_cast<size_t>(b.img_index) * hw * channels;
      for (int i = 0; i < n_rays; ++i) {
        int32_t ind = static_cast<int32_t>(rng.bounded(hw));
        b.inds[i] = ind;
        std::memcpy(&b.pix[static_cast<size_t>(i) * channels],
                    img + static_cast<size_t>(ind) * channels,
                    sizeof(float) * channels);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_producer.wait(lk, [&] {
        return stop.load(std::memory_order_relaxed) ||
               queue.size() < queue_depth;
      });
      if (stop.load(std::memory_order_relaxed)) return;
      queue.push_back(std::move(b));
      cv_consumer.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* rb_create(const float* images, int n_images, int h, int w, int channels,
                int n_rays, uint64_t seed, int queue_depth, int n_threads) {
  auto* rb = new RayBatcher();
  rb->images = images;
  rb->n_images = n_images;
  rb->hw = h * w;
  rb->channels = channels;
  rb->n_rays = n_rays;
  rb->queue_depth = queue_depth > 0 ? queue_depth : 4;
  if (n_threads <= 0) n_threads = 2;
  for (int t = 0; t < n_threads; ++t) {
    rb->workers.emplace_back([rb, seed, t] { rb->producer(seed, t); });
  }
  return rb;
}

// Blocks until a batch is ready; copies into caller buffers. Returns the
// sampled image index (>= 0), or -1 on shutdown.
int rb_next(void* handle, int32_t* out_inds, float* out_pix) {
  auto* rb = static_cast<RayBatcher*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(rb->mu);
    rb->cv_consumer.wait(lk, [&] {
      return rb->stop.load(std::memory_order_relaxed) || !rb->queue.empty();
    });
    if (rb->queue.empty()) return -1;
    b = std::move(rb->queue.front());
    rb->queue.pop_front();
    rb->cv_producer.notify_one();
  }
  std::memcpy(out_inds, b.inds.data(), sizeof(int32_t) * rb->n_rays);
  std::memcpy(out_pix, b.pix.data(),
              sizeof(float) * rb->n_rays * rb->channels);
  return b.img_index;
}

void rb_destroy(void* handle) {
  auto* rb = static_cast<RayBatcher*>(handle);
  rb->stop.store(true);
  rb->cv_producer.notify_all();
  rb->cv_consumer.notify_all();
  for (auto& t : rb->workers) t.join();
  delete rb;
}

}  // extern "C"
