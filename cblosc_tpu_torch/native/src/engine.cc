// Native chunk engine: persistent worker pool + chunk assembly + C ABI.
//
// Plays the role of the reference's threaded block engine
// (t_blosc/init_threads/parallel_blosc, blosc.c:871-1949) with a modern
// design: a persistent std::thread pool with an atomic work queue
// (dynamic block scheduling, like the reference's mutex-guarded block
// counter) and a deterministic block-ordered output layout computed by
// prefix sum (instead of arrival-order reservation).
//
// Exported C ABI (used by cblosc_tpu_torch/native/binding.py via ctypes):
//   cbt_compress_chunk / cbt_decompress_chunk / cbt_getitem /
//   cbt_free_resources / cbt_after_fork_in_child / cbt_set_zstd_path /
//   filter and codec entry points for cross-validation tests.

#include "common.h"

#include <atomic>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace cbt {

namespace {

// ---------------------------------------------------------------------
// Persistent worker pool (lazily started, resized on demand; the role of
// init_threads/blosc_release_threadpool, blosc.c:1890-1949, 2262-2309).
class WorkerPool {
 public:
  static WorkerPool& instance() {
    static WorkerPool pool;
    return pool;
  }

  // Run fn(block) for every block in [0, nblocks) on `nthreads` workers
  // with dynamic scheduling; returns false if any call returned false.
  bool parallel_for(int nthreads, int64_t nblocks,
                    const std::function<bool(int64_t)>& fn) {
    if (nthreads <= 1 || nblocks <= 1) {
      for (int64_t j = 0; j < nblocks; ++j) {
        if (!fn(j)) return false;
      }
      return true;
    }
    ensure((size_t)(nthreads - 1));
    std::atomic<int64_t> next{0};
    std::atomic<bool> ok{true};
    auto worker = [&]() {
      for (;;) {
        int64_t j = next.fetch_add(1, std::memory_order_relaxed);
        if (j >= nblocks || !ok.load(std::memory_order_relaxed)) return;
        if (!fn(j)) ok.store(false, std::memory_order_relaxed);
      }
    };
    {
      std::unique_lock<std::mutex> lk(mu_);
      task_ = worker;
      want_ = (int)std::min<int64_t>(nthreads - 1, nblocks - 1);
      started_ = 0;
      done_ = 0;
      ++epoch_;
      cv_.notify_all();
    }
    worker();  // the caller is a worker too
    {
      std::unique_lock<std::mutex> lk(mu_);
      fin_.wait(lk, [&] { return done_ >= want_; });
      task_ = nullptr;
    }
    return ok.load();
  }

  void shutdown() {
    std::vector<std::thread> dying;
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      ++epoch_;
      cv_.notify_all();
      dying.swap(threads_);
    }
    for (auto& t : dying) t.join();
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = false;
    }
  }

  // Fork safety (the reference's pthread_atfork handler,
  // blosc.c:2210-2244): a forked child holds the parent's thread handles
  // but none of its threads, so a wait for them would never end. Call in
  // the child, before any other call: the handles go to storage that is
  // never freed (a joinable std::thread's destructor calls
  // std::terminate, and joining waits forever), the locks a vanished
  // thread may have held are built anew, and the next parallel_for
  // starts fresh workers.
  void after_fork_in_child() {
    auto* lost = new std::vector<std::thread>();
    lost->swap(threads_);
    new (&mu_) std::mutex();
    new (&cv_) std::condition_variable();
    new (&fin_) std::condition_variable();
    new (&task_) std::function<void()>();
    epoch_ = 0;
    want_ = 0;
    started_ = 0;
    done_ = 0;
    stop_ = false;
  }

  ~WorkerPool() { shutdown(); }

 private:
  WorkerPool() = default;

  void ensure(size_t n) {
    std::unique_lock<std::mutex> lk(mu_);
    while (threads_.size() < n) {
      threads_.emplace_back([this] { loop(); });
    }
  }

  void loop() {
    uint64_t seen = 0;
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || (task_ && epoch_ != seen &&
                                            started_ < want_); });
        if (stop_) return;
        seen = epoch_;
        ++started_;
        job = task_;
      }
      job();
      {
        std::unique_lock<std::mutex> lk(mu_);
        ++done_;
        fin_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable fin_;
  std::vector<std::thread> threads_;
  std::function<void()> task_;
  uint64_t epoch_ = 0;
  int want_ = 0;
  int started_ = 0;
  int done_ = 0;
  bool stop_ = false;
};

// ---------------------------------------------------------------------
// Policies (must agree with cblosc_tpu_torch/core/policy.py).

bool hcr_codec(int compcode) {
  return compcode == kLZ4HC || compcode == kZlib || compcode == kZstd;
}

bool split_block(int compcode, int typesize, int blocksize, int splitmode) {
  switch (splitmode) {
    case kAlwaysSplit:
      return true;
    case kNeverSplit:
      return false;
    case kAutoSplit:
      return (compcode == kBloscLZ || compcode == kSnappy) &&
             typesize <= kMaxSplits && blocksize / typesize >= kMinBufferSize;
    case kForwardCompatSplit:
    default:
      return compcode != kZstd && typesize <= kMaxSplits &&
             blocksize / typesize >= kMinBufferSize;
  }
}

int64_t compute_blocksize(int clevel, int typesize, int64_t nbytes,
                          int64_t forced, int compcode, int splitmode) {
  if (nbytes < typesize) return 1;
  int64_t bs = nbytes;
  if (forced) {
    bs = forced;
    if (bs < kMinBufferSize) bs = kMinBufferSize;
  } else if (nbytes >= kL1) {
    bs = kL1;
    if (hcr_codec(compcode)) bs *= 2;
    switch (clevel) {
      case 0: bs /= 4; break;
      case 1: bs /= 2; break;
      case 2: break;
      case 3: bs *= 2; break;
      case 4:
      case 5: bs *= 4; break;
      case 6:
      case 7:
      case 8: bs *= 8; break;
      case 9:
        bs *= 8;
        if (hcr_codec(compcode)) bs *= 2;
        break;
    }
  }
  if (clevel > 0 && split_block(compcode, typesize, (int)bs, splitmode)) {
    if (bs > (1 << 18)) bs = 1 << 18;
    bs *= typesize;
    if (bs < (1 << 16)) bs = 1 << 16;
    if (bs > (1 << 20)) bs = 1 << 20;
  }
  if (bs > nbytes) bs = nbytes;
  if (bs > typesize) bs = bs / typesize * typesize;
  return bs;
}

// ---------------------------------------------------------------------
// Per-block compression (role of blosc_c, blosc.c:591-722).
// Returns the encoded size, or -1 when the block cannot be represented
// within its worst-case budget.
int64_t compress_block(int compcode, int clevel, int doshuffle, int typesize,
                       bool dont_split, const uint8_t* block, int64_t bsize,
                       bool leftover, uint8_t* out, int64_t budget,
                       uint8_t* tmp, uint8_t* tmp2) {
  const uint8_t* filtered = block;
  if (doshuffle == kShuffle && typesize > 1) {
    byte_shuffle(typesize, bsize, block, tmp);
    filtered = tmp;
  } else if (doshuffle == kBitShuffle && bsize >= typesize) {
    bit_shuffle(typesize, bsize, block, tmp, tmp2);
    filtered = tmp;
  }

  int nsplits = (dont_split || leftover) ? 1 : typesize;
  int64_t neblock = bsize / nsplits;
  int64_t pos = 0;
  for (int s = 0; s < nsplits; ++s) {
    int64_t maxout = neblock;
    if (compcode == kSnappy) {
      // snappy gets headroom past neblock (snappy_max_compressed_length
      // role, blosc.c:640-645); a stream in (neblock, maxout] is stored
      // compressed, mirroring the reference and the numpy engine.
      maxout = 32 + neblock + neblock / 6;
    }
    int64_t remaining = budget - pos - 4;
    if (maxout > remaining) maxout = remaining;
    if (maxout <= 0) return -1;
    const uint8_t* stream = filtered + s * neblock;
    int cbytes = 0;
    switch (compcode) {
      case kBloscLZ:
        cbytes = blosclz_encode(clevel, stream, (int)neblock, out + pos + 4,
                                (int)maxout, !dont_split);
        break;
      case kLZ4:
        cbytes = lz4_encode(stream, (int)neblock, out + pos + 4, (int)maxout,
                            10 - clevel);
        break;
      case kLZ4HC:
        cbytes = lz4hc_encode(stream, (int)neblock, out + pos + 4,
                              (int)maxout, clevel);
        break;
      case kSnappy:
        cbytes = snappy_encode(stream, (int)neblock, out + pos + 4,
                               (int)maxout);
        break;
      case kZlib:
        cbytes = zlib_encode(clevel, stream, (int)neblock, out + pos + 4,
                             (int)maxout);
        break;
      case kZstd:
        cbytes = zstd_encode(clevel, stream, (int)neblock, out + pos + 4,
                             (int)maxout);
        break;
      default:
        return -2;  // codec not handled natively; caller falls back
    }
    if (cbytes == -2) return -2;
    if (cbytes < 0) return -1;
    if (cbytes == 0 || cbytes == neblock) {
      if (pos + 4 + neblock > budget) return -1;
      std::memcpy(out + pos + 4, stream, neblock);
      cbytes = (int)neblock;
    }
    store_i32(out + pos, cbytes);
    pos += 4 + cbytes;
  }
  return pos;
}

// Per-block decompression (role of blosc_d, blosc.c:725-800).
bool decompress_block(int compcode, int doshuffle, int typesize,
                      bool dont_split, int64_t blocksize, const uint8_t* chunk,
                      int64_t chunk_len, int64_t offset, uint8_t* dst,
                      int64_t bsize, bool leftover, uint8_t* tmp,
                      uint8_t* tmp2) {
  int nsplits = 1;
  if (!dont_split && !leftover && typesize <= kMaxSplits &&
      blocksize / typesize >= kMinBufferSize) {
    nsplits = typesize;
  }
  int64_t neblock = bsize / nsplits;
  bool filtered = (doshuffle == kShuffle && typesize > 1) ||
                  (doshuffle == kBitShuffle && bsize >= typesize);
  uint8_t* target = filtered ? tmp : dst;

  int64_t pos = offset;
  for (int s = 0; s < nsplits; ++s) {
    if (pos < 0 || pos > chunk_len - 4) return false;
    int32_t cbytes = load_i32(chunk + pos);
    pos += 4;
    if (cbytes < 0 || cbytes > chunk_len - pos) return false;
    const uint8_t* stream = chunk + pos;
    int n;
    if (cbytes == neblock) {
      std::memcpy(target + s * neblock, stream, neblock);
      n = (int)neblock;
    } else {
      switch (compcode) {
        case kBloscLZ:
          n = blosclz_decode(stream, cbytes, target + s * neblock,
                             (int)neblock);
          break;
        case kLZ4:
        case kLZ4HC:
          n = lz4_decode(stream, cbytes, target + s * neblock, (int)neblock);
          break;
        case kSnappy:
          n = snappy_decode(stream, cbytes, target + s * neblock,
                            (int)neblock);
          break;
        case kZlib:
          n = zlib_decode(stream, cbytes, target + s * neblock,
                          (int)neblock);
          break;
        case kZstd:
          n = zstd_decode(stream, cbytes, target + s * neblock,
                          (int)neblock);
          break;
        default:
          return false;
      }
      if (n != neblock) return false;
    }
    pos += cbytes;
  }
  if (doshuffle == kShuffle && typesize > 1) {
    byte_unshuffle(typesize, bsize, tmp, dst);
  } else if (doshuffle == kBitShuffle && bsize >= typesize) {
    bit_unshuffle(typesize, bsize, tmp, dst, tmp2);
  }
  return true;
}

// Per-worker filter scratch (role of thread_context->tmp/tmp2,
// blosc.c:133-140): persists across jobs, grown on demand.
uint8_t* thread_scratch(int64_t need) {
  static thread_local std::vector<uint8_t> buf;
  if ((int64_t)buf.size() < need) buf.resize((size_t)need);
  return buf.data();
}

}  // namespace
}  // namespace cbt

// ---------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------

extern "C" {

// Compress a whole buffer into one chunk. Returns cbytes, 0 when the data
// is incompressible and does not fit destsize, or a negative error code.
// `blocksize_in` / `dont_split_in` carry the geometry the caller already
// fixed (cblosc_tpu_torch.core.engine.build_context); pass 0 / -1 to let the
// native policy (identical tables) decide.
int64_t cbt_compress_chunk(int clevel, int doshuffle, int typesize,
                           const uint8_t* src, int64_t nbytes, uint8_t* dst,
                           int64_t destsize, int compcode,
                           int64_t blocksize_in, int dont_split_in,
                           int nthreads) {
  using namespace cbt;
  if (clevel < 0 || clevel > 9 || typesize <= 0) return -10;
  if (destsize < kMaxOverhead) return -10;
  if (typesize > kMaxTypesize) typesize = 1;
  if (destsize > nbytes + kMaxOverhead) destsize = nbytes + kMaxOverhead;

  int64_t blocksize =
      blocksize_in > 0
          ? blocksize_in
          : compute_blocksize(clevel, typesize, nbytes, 0, compcode,
                              kForwardCompatSplit);
  int64_t nblocks = blocksize > 0 ? nbytes / blocksize : 0;
  int64_t leftover = blocksize > 0 ? nbytes % blocksize : 0;
  if (leftover) nblocks++;

  bool memcpyed = (clevel == 0) || (nbytes < kMinBufferSize);
  bool dont_split =
      dont_split_in >= 0
          ? dont_split_in != 0
          : !split_block(compcode, typesize, (int)blocksize,
                         kForwardCompatSplit);

  uint8_t flags = 0;
  if (doshuffle == kShuffle) flags |= kDoShuffle;
  if (doshuffle == kBitShuffle) flags |= kDoBitshuffle;
  if (dont_split) flags |= kDontSplit;
  if (compcode < 0 || compcode > kZstd) return -2;
  static const uint8_t compformat[6] = {0, 1, 1, 2, 3, 4};
  flags |= compformat[compcode] << 5;

  auto write_header = [&](uint8_t fl, int64_t cbytes) {
    dst[0] = 2;  // chunk format version
    dst[1] = 1;  // codec format version (all codecs are at 1)
    dst[2] = fl;
    dst[3] = (uint8_t)typesize;
    store_i32(dst + 4, (int32_t)nbytes);
    store_i32(dst + 8, (int32_t)blocksize);
    store_i32(dst + 12, (int32_t)cbytes);
  };

  auto memcpy_path = [&]() -> int64_t {
    int64_t cbytes = nbytes + kMaxOverhead;
    if (cbytes > destsize) return 0;
    write_header(flags | kMemcpyed, cbytes);
    std::memcpy(dst + kHeaderLen, src, nbytes);
    return cbytes;
  };

  if (memcpyed) return memcpy_path();
  if (!codec_native_available(compcode)) return -2;  // caller falls back

  // Per-block worst-case budget (cf. ebsize, blosc.c:1745).
  int64_t budget = blocksize + 4 * (int64_t)typesize;
  std::vector<uint8_t> scratch((size_t)(nblocks * budget));
  std::vector<int64_t> sizes((size_t)nblocks, -1);
  bool ok = WorkerPool::instance().parallel_for(
      nthreads, nblocks, [&](int64_t j) -> bool {
        uint8_t* tl = thread_scratch(2 * blocksize);
        int64_t bsize = blocksize;
        bool lob = false;
        if (j == nblocks - 1 && leftover) {
          bsize = leftover;
          lob = true;
        }
        int64_t n = compress_block(
            compcode, clevel, doshuffle, typesize, dont_split,
            src + j * blocksize, bsize, lob, scratch.data() + j * budget,
            budget, tl, tl + blocksize);
        sizes[(size_t)j] = n;
        return n >= 0;
      });

  if (ok) {
    int64_t total = kHeaderLen + 4 * nblocks;
    for (int64_t j = 0; j < nblocks; ++j) total += sizes[(size_t)j];
    if (total <= destsize) {
      write_header(flags, total);
      int64_t pos = kHeaderLen + 4 * nblocks;
      for (int64_t j = 0; j < nblocks; ++j) {
        store_i32(dst + kHeaderLen + 4 * j, (int32_t)pos);
        std::memcpy(dst + pos, scratch.data() + j * budget, sizes[(size_t)j]);
        pos += sizes[(size_t)j];
      }
      return total;
    }
  }
  // Last chance: verbatim copy (blosc.c:1264-1272).
  if (nbytes + kMaxOverhead <= destsize) return memcpy_path();
  return 0;
}

// Decompress a chunk. Returns nbytes or a negative error code.
int64_t cbt_decompress_chunk(const uint8_t* chunk, int64_t chunk_len,
                             uint8_t* dst, int64_t destsize, int nthreads) {
  using namespace cbt;
  if (chunk_len < kHeaderLen) return -1;
  uint8_t version = chunk[0];
  uint8_t flags = chunk[2];
  int typesize = chunk[3];
  int64_t nbytes = load_i32(chunk + 4);
  int64_t blocksize = load_i32(chunk + 8);
  int64_t cbytes = load_i32(chunk + 12);
  if (nbytes == 0) return 0;
  if (version != 2 || (flags & kReservedBit)) return -1;
  if (blocksize <= 0 || typesize <= 0 || nbytes > destsize ||
      cbytes > chunk_len) {
    return -1;
  }
  if (flags & kMemcpyed) {
    if (nbytes + kMaxOverhead != cbytes) return -1;
    std::memcpy(dst, chunk + kHeaderLen, nbytes);
    return nbytes;
  }
  int compformat = (flags & 0xE0) >> 5;
  static const int fmt2code[5] = {kBloscLZ, kLZ4, kSnappy, kZlib, kZstd};
  if (compformat > 4) return -1;
  int compcode = fmt2code[compformat];
  // LZ4HC shares the LZ4 wire format; the header cannot distinguish them
  if (!codec_native_available(compcode)) return -2;  // fall back
  if (chunk[1] != 1) return -9;

  int64_t nblocks = nbytes / blocksize;
  int64_t leftover = nbytes % blocksize;
  if (leftover) nblocks++;
  if (nblocks > (cbytes - kHeaderLen) / 4) return -1;

  int doshuffle = (flags & kDoShuffle) ? kShuffle
                  : (flags & kDoBitshuffle) ? kBitShuffle
                                            : kNoShuffle;
  bool dont_split = flags & kDontSplit;

  bool ok = WorkerPool::instance().parallel_for(
      nthreads, nblocks, [&](int64_t j) -> bool {
        uint8_t* tl = thread_scratch(2 * blocksize);
        int64_t bsize = blocksize;
        bool lob = false;
        if (j == nblocks - 1 && leftover) {
          bsize = leftover;
          lob = true;
        }
        int64_t offset = load_i32(chunk + kHeaderLen + 4 * j);
        return decompress_block(compcode, doshuffle, typesize, dont_split,
                                blocksize, chunk, chunk_len, offset,
                                dst + j * blocksize, bsize, lob, tl,
                                tl + blocksize);
      });
  return ok ? nbytes : -1;
}

// Partial decompression (role of blosc_getitem, blosc.c:1574-1703):
// decode only the blocks overlapping items [start, start+nitems) and
// copy the requested slice out of each. Single-threaded, as the
// reference's is. Returns the byte count or a negative error code
// (-2 = codec not native; caller falls back).
int64_t cbt_getitem(const uint8_t* chunk, int64_t chunk_len, int64_t start,
                    int64_t nitems, uint8_t* dst, int64_t destsize) {
  using namespace cbt;
  if (chunk_len < kHeaderLen) return -1;
  uint8_t version = chunk[0];
  uint8_t flags = chunk[2];
  int typesize = chunk[3];
  int64_t nbytes = load_i32(chunk + 4);
  int64_t blocksize = load_i32(chunk + 8);
  int64_t cbytes = load_i32(chunk + 12);
  if (version != 2 || (flags & kReservedBit)) return -1;
  if (blocksize <= 0 || typesize <= 0 || cbytes > chunk_len) return -1;
  int64_t ts = typesize;
  int64_t stop = start + nitems;
  if (start < 0 || nitems < 0 || stop * ts > nbytes) return -1;
  if (nitems * ts > destsize) return -1;
  if (nitems == 0) return 0;

  if (flags & kMemcpyed) {
    if (nbytes + kMaxOverhead != cbytes) return -1;
    std::memcpy(dst, chunk + kHeaderLen + start * ts, (size_t)(nitems * ts));
    return nitems * ts;
  }
  int compformat = (flags & 0xE0) >> 5;
  static const int fmt2code[5] = {kBloscLZ, kLZ4, kSnappy, kZlib, kZstd};
  if (compformat > 4) return -1;
  int compcode = fmt2code[compformat];
  if (!codec_native_available(compcode)) return -2;
  if (chunk[1] != 1) return -9;

  int64_t nblocks = nbytes / blocksize;
  int64_t leftover = nbytes % blocksize;
  if (leftover) nblocks++;
  if (nblocks > (cbytes - kHeaderLen) / 4) return -1;

  int doshuffle = (flags & kDoShuffle) ? kShuffle
                  : (flags & kDoBitshuffle) ? kBitShuffle
                                            : kNoShuffle;
  bool dont_split = flags & kDontSplit;

  std::vector<uint8_t> block((size_t)blocksize);
  uint8_t* tl = thread_scratch(2 * blocksize);
  int64_t ntbytes = 0;
  for (int64_t j = (start * ts) / blocksize;
       j < nblocks && j * blocksize < stop * ts; ++j) {
    int64_t bsize = blocksize;
    bool lob = false;
    if (j == nblocks - 1 && leftover) {
      bsize = leftover;
      lob = true;
    }
    int64_t startb = start * ts - j * blocksize;
    if (startb < 0) startb = 0;
    int64_t stopb = stop * ts - j * blocksize;
    if (stopb > bsize) stopb = bsize;
    if (stopb <= startb) continue;
    int64_t offset = load_i32(chunk + kHeaderLen + 4 * j);
    if (!decompress_block(compcode, doshuffle, typesize, dont_split,
                          blocksize, chunk, chunk_len, offset, block.data(),
                          bsize, lob, tl, tl + blocksize)) {
      return -1;
    }
    std::memcpy(dst + ntbytes, block.data() + startb,
                (size_t)(stopb - startb));
    ntbytes += stopb - startb;
  }
  return ntbytes;
}

void cbt_free_resources() { cbt::WorkerPool::instance().shutdown(); }

void cbt_after_fork_in_child() {
  cbt::WorkerPool::instance().after_fork_in_child();
}

// Name the libzstd that zstd calls dlopen; "" leaves zstd unavailable.
// Takes effect only before the first zstd call.
void cbt_set_zstd_path(const char* path) { cbt::set_zstd_path(path); }

// Direct kernel entry points for cross-validation tests.
void cbt_shuffle(int typesize, int64_t n, const uint8_t* src, uint8_t* dst) {
  cbt::byte_shuffle(typesize, n, src, dst);
}
void cbt_unshuffle(int typesize, int64_t n, const uint8_t* src, uint8_t* dst) {
  cbt::byte_unshuffle(typesize, n, src, dst);
}
void cbt_bitshuffle(int typesize, int64_t n, const uint8_t* src, uint8_t* dst,
                    uint8_t* tmp) {
  cbt::bit_shuffle(typesize, n, src, dst, tmp);
}
void cbt_bitunshuffle(int typesize, int64_t n, const uint8_t* src,
                      uint8_t* dst, uint8_t* tmp) {
  cbt::bit_unshuffle(typesize, n, src, dst, tmp);
}
int cbt_blosclz_compress(int clevel, const uint8_t* src, int len, uint8_t* dst,
                         int maxout, int split) {
  return cbt::blosclz_encode(clevel, src, len, dst, maxout, split != 0);
}
int cbt_blosclz_decompress(const uint8_t* src, int len, uint8_t* dst,
                           int maxout) {
  return cbt::blosclz_decode(src, len, dst, maxout);
}
int cbt_lz4_compress(const uint8_t* src, int len, uint8_t* dst, int maxout,
                     int accel) {
  return cbt::lz4_encode(src, len, dst, maxout, accel);
}
int cbt_lz4hc_compress(const uint8_t* src, int len, uint8_t* dst, int maxout,
                       int clevel) {
  return cbt::lz4hc_encode(src, len, dst, maxout, clevel);
}
int cbt_lz4_decompress(const uint8_t* src, int len, uint8_t* dst, int maxout) {
  return cbt::lz4_decode(src, len, dst, maxout);
}

}  // extern "C"
