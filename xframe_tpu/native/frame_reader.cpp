// Multithreaded raw-frame batch reader for the correlate worker.
//
// Replacement for the IO side of the reference's fork-based frame
// fan-out (reference Multiprocessing.py process_mp_request over frame files +
// correlate.py:302 process_batch): a thread pool reads many .raw files
// straight into one preallocated batch buffer, so Python streams device-ready
// numpy batches while the previous batch is correlating on the device.
//
// C ABI (used via ctypes from xframe_tpu.native):
//   int read_frames(const char** paths, int n_paths, float* out,
//                   long frame_elems, int dtype_code, int n_threads,
//                   unsigned char* ok_out);
// dtype_code: 0 = float32, 1 = float64, 2 = int32, 3 = uint16, 4 = int16
// Returns number of successfully read frames. EVERY failure path (missing
// file, short read) zero-fills its output slot — the batch buffer may be
// uninitialized memory — and reports per-frame success in ok_out (nullable)
// so callers can exclude failed frames from accumulation.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename T>
bool read_one(const char* path, float* dst, long frame_elems) {
    FILE* f = std::fopen(path, "rb");
    if (!f) {
        std::memset(dst, 0, sizeof(float) * frame_elems);
        return false;
    }
    std::vector<T> buf(static_cast<size_t>(frame_elems));
    size_t got = std::fread(buf.data(), sizeof(T),
                            static_cast<size_t>(frame_elems), f);
    std::fclose(f);
    if (got != static_cast<size_t>(frame_elems)) {
        std::memset(dst, 0, sizeof(float) * frame_elems);
        return false;
    }
    for (long i = 0; i < frame_elems; ++i)
        dst[i] = static_cast<float>(buf[i]);
    return true;
}

bool read_dispatch(const char* path, float* dst, long frame_elems,
                   int dtype_code) {
    switch (dtype_code) {
        case 0: {  // float32: read directly into the output slot
            FILE* f = std::fopen(path, "rb");
            if (!f) {
                std::memset(dst, 0, sizeof(float) * frame_elems);
                return false;
            }
            size_t got = std::fread(dst, sizeof(float),
                                    static_cast<size_t>(frame_elems), f);
            std::fclose(f);
            if (got != static_cast<size_t>(frame_elems)) {
                std::memset(dst + got, 0,
                            sizeof(float) * (frame_elems - got));
                return false;
            }
            return true;
        }
        case 1: return read_one<double>(path, dst, frame_elems);
        case 2: return read_one<int32_t>(path, dst, frame_elems);
        case 3: return read_one<uint16_t>(path, dst, frame_elems);
        case 4: return read_one<int16_t>(path, dst, frame_elems);
        default:
            std::memset(dst, 0, sizeof(float) * frame_elems);
            return false;
    }
}

}  // namespace

extern "C" int read_frames(const char** paths, int n_paths, float* out,
                           long frame_elems, int dtype_code, int n_threads,
                           unsigned char* ok_out) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int> next(0);
    std::atomic<int> ok(0);
    auto worker = [&]() {
        while (true) {
            int i = next.fetch_add(1);
            if (i >= n_paths) break;
            bool good = read_dispatch(
                paths[i], out + static_cast<long>(i) * frame_elems,
                frame_elems, dtype_code);
            if (ok_out) ok_out[i] = good ? 1 : 0;
            if (good) ok.fetch_add(1);
        }
    };
    std::vector<std::thread> pool;
    int n = n_threads < n_paths ? n_threads : n_paths;
    pool.reserve(n);
    for (int t = 0; t < n; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return ok.load();
}
