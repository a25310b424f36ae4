// gamd_io: the native dataset packer of the PyTorch port (a copy of the
// JAX package's csrc/gamd_io.cpp, with the same C signature; host code,
// not a device kernel).
//
// Training reads thousands of tiny .npz frames; this library scans a
// trajectory directory once, parses each (STORED, uncompressed) zip that
// np.savez writes, and copies the pos/forces payloads into one contiguous
// float32 blob, parallelized across hardware threads. Python binds it via
// ctypes (gamd_tpu_torch/train/native_io.py), which builds it with g++ at
// first use (no -march=native: the library must run on any x86-64 host).
//
// Only the npz features numpy emits are supported: STORE method, v1/v2 npy
// headers, little-endian '<f4'/'<f8' arrays in C order (2-D Fortran order
// is transposed).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Array {
  std::vector<int64_t> shape;
  std::vector<float> data;
  bool ok = false;
};

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// Parse a v1/v2 .npy payload into floats (converts f8 -> f4).
Array parse_npy(const uint8_t* p, size_t n) {
  Array out;
  if (n < 10 || memcmp(p, "\x93NUMPY", 6) != 0) return out;
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = rd16(p + 8);
    header_off = 10;
  } else {
    header_len = rd32(p + 8);
    header_off = 12;
  }
  if (header_off + header_len > n) return out;
  std::string hdr(reinterpret_cast<const char*>(p + header_off), header_len);

  bool f8 = hdr.find("'<f8'") != std::string::npos;
  bool f4 = hdr.find("'<f4'") != std::string::npos;
  if (!f4 && !f8) return out;
  // A column-major array is saved with fortran_order: True and its
  // payload transposed.
  bool fortran = hdr.find("'fortran_order': True") != std::string::npos;

  size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) return out;
  size_t lp = hdr.find('(', sp), rp = hdr.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return out;
  std::string dims = hdr.substr(lp + 1, rp - lp - 1);
  int64_t total = 1;
  size_t pos = 0;
  while (pos < dims.size()) {
    while (pos < dims.size() && (dims[pos] == ' ' || dims[pos] == ',')) pos++;
    if (pos >= dims.size()) break;
    int64_t v = strtoll(dims.c_str() + pos, nullptr, 10);
    out.shape.push_back(v);
    total *= v;
    while (pos < dims.size() && dims[pos] != ',') pos++;
  }
  const uint8_t* payload = p + header_off + header_len;
  size_t avail = n - header_off - header_len;
  size_t need = size_t(total) * (f8 ? 8 : 4);
  if (avail < need) return out;
  out.data.resize(total);
  if (f4) {
    memcpy(out.data.data(), payload, need);
  } else {
    const double* src = reinterpret_cast<const double*>(payload);
    for (int64_t i = 0; i < total; i++) out.data[i] = float(src[i]);
  }
  if (fortran && out.shape.size() == 2) {
    // Transpose column-major [R, C] payload into C order.
    int64_t r_dim = out.shape[0], c_dim = out.shape[1];
    std::vector<float> c_order(total);
    for (int64_t r = 0; r < r_dim; r++)
      for (int64_t c = 0; c < c_dim; c++)
        c_order[r * c_dim + c] = out.data[c * r_dim + r];
    out.data.swap(c_order);
  } else if (fortran && out.shape.size() > 2) {
    return out;  // unsupported; stays !ok
  }
  out.ok = true;
  return out;
}

// Extract one named member from a STORED npz in memory.
//
// numpy >= 1.22 streams zip members (general-purpose flag bit 3), so local
// file headers carry zero sizes with the real ones in trailing data
// descriptors — the central directory at the end of the archive is the only
// reliable source of sizes and offsets.
Array npz_member(const std::vector<uint8_t>& buf, const std::string& name) {
  const std::string want = name + ".npy";
  if (buf.size() < 22) return Array{};

  // Find the end-of-central-directory record (scan back over the comment).
  size_t eocd = std::string::npos;
  size_t start = buf.size() >= 22 + 65536 ? buf.size() - 22 - 65536 : 0;
  for (size_t i = buf.size() - 22 + 1; i-- > start;) {
    if (rd32(&buf[i]) == 0x06054b50) {
      eocd = i;
      break;
    }
  }
  if (eocd == std::string::npos) return Array{};
  uint16_t n_entries = rd16(&buf[eocd + 10]);
  size_t cd_off = rd32(&buf[eocd + 16]);

  for (uint16_t e = 0; e < n_entries && cd_off + 46 <= buf.size(); e++) {
    if (rd32(&buf[cd_off]) != 0x02014b50) break;  // central dir magic
    uint16_t method = rd16(&buf[cd_off + 10]);
    uint32_t comp_size = rd32(&buf[cd_off + 20]);
    uint16_t name_len = rd16(&buf[cd_off + 28]);
    uint16_t extra_len = rd16(&buf[cd_off + 30]);
    uint16_t comment_len = rd16(&buf[cd_off + 32]);
    uint32_t local_off = rd32(&buf[cd_off + 42]);
    std::string fname(reinterpret_cast<const char*>(&buf[cd_off + 46]),
                      name_len);
    if (fname == want && method == 0 && local_off + 30 <= buf.size()) {
      // Re-read the LOCAL header for its own name/extra lengths.
      uint16_t lname = rd16(&buf[local_off + 26]);
      uint16_t lextra = rd16(&buf[local_off + 28]);
      size_t data_off = local_off + 30 + lname + lextra;
      if (data_off + comp_size <= buf.size()) {
        return parse_npy(&buf[data_off], comp_size);
      }
      return Array{};
    }
    cd_off += 46 + name_len + extra_len + comment_len;
  }
  return Array{};
}

bool read_file(const std::string& path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(sz);
  size_t got = fread(out->data(), 1, sz, f);
  fclose(f);
  return got == size_t(sz);
}

}  // namespace

extern "C" {

// Pack frames dataset_dir/{prefix}{seed}_{t}.npz (keys: "pos", "forces")
// into caller-provided buffers of shape [n_frames, n_atoms, 3] float32.
// Frame order is seed-major (flat = seed * sample_num + t), matching the
// reference's flat indexing (train_utils.py:50-52).
//
// drop_m_site != 0 removes every 4th atom row (TIP4P virtual sites,
// train_utils.py:58-64): source frames have n_src = n_atoms / 3 * 4 rows.
//
// Returns the number of frames packed; frames that failed to parse are
// zero-filled and counted in *n_failed.
int64_t gamd_pack_trajectory(const char* dataset_dir, const char* prefix,
                             int64_t seed_num, int64_t sample_num,
                             int64_t n_atoms, int drop_m_site,
                             float* pos_out, float* forces_out,
                             int64_t* n_failed_out) {
  const int64_t n_frames = seed_num * sample_num;
  const int64_t frame_elems = n_atoms * 3;
  std::atomic<int64_t> n_done{0}, n_failed{0};

  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::thread> workers;
  std::atomic<int64_t> next{0};

  auto work = [&]() {
    std::vector<uint8_t> buf;
    while (true) {
      int64_t flat = next.fetch_add(1);
      if (flat >= n_frames) return;
      int64_t seed = flat / sample_num, t = flat % sample_num;
      char path[4096];
      snprintf(path, sizeof(path), "%s/%s%lld_%lld.npz", dataset_dir, prefix,
               (long long)seed, (long long)t);
      float* pdst = pos_out + flat * frame_elems;
      float* fdst = forces_out + flat * frame_elems;
      bool ok = false;
      if (read_file(path, &buf)) {
        Array pos = npz_member(buf, "pos");
        Array forces = npz_member(buf, "forces");
        if (pos.ok && forces.ok) {
          auto copy_rows = [&](const Array& a, float* dst) {
            if (!drop_m_site) {
              int64_t n = std::min<int64_t>(a.data.size(), frame_elems);
              memcpy(dst, a.data.data(), n * sizeof(float));
              return n == frame_elems;
            }
            // source rows: keep i where i % 4 < 3
            int64_t kept = 0;
            int64_t src_rows = a.shape.empty() ? 0 : a.shape[0];
            for (int64_t r = 0; r < src_rows && kept < n_atoms; r++) {
              if (r % 4 == 3) continue;
              memcpy(dst + kept * 3, a.data.data() + r * 3,
                     3 * sizeof(float));
              kept++;
            }
            return kept == n_atoms;
          };
          ok = copy_rows(pos, pdst) && copy_rows(forces, fdst);
        }
      }
      if (!ok) {
        memset(pdst, 0, frame_elems * sizeof(float));
        memset(fdst, 0, frame_elems * sizeof(float));
        n_failed.fetch_add(1);
      }
      n_done.fetch_add(1);
    }
  };

  for (int i = 0; i < n_threads; i++) workers.emplace_back(work);
  for (auto& w : workers) w.join();
  if (n_failed_out) *n_failed_out = n_failed.load();
  return n_done.load();
}

}  // extern "C"
