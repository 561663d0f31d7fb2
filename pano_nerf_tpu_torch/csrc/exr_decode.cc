// Fast OpenEXR scanline decoder: ZIP/ZIPS/uncompressed, HALF/FLOAT/UINT.
//
// Native counterpart of the hot path in pano_nerf_tpu_torch/data/io_exr.py:
// dataset loading decodes hundreds of multi-megapixel EXR quads, and the
// per-scanline Python loop dominates. This decoder does the full
// chunk -> inflate -> unpredict -> deinterleave -> half->float conversion in
// C++ and writes planar float32 output. Exposed through ctypes
// (pano_nerf_tpu_torch/data/io_exr.py); the Python codec remains the fallback
// and the reference implementation for tests.
//
// Built at first use by pano_nerf_tpu_torch/kernels/build.py load_host_library:
// g++ -O3 -shared -fPIC exr_decode.cc -o <library> -lz

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr int kMagic = 20000630;

struct Channel {
  std::string name;
  int pixel_type;  // 0=UINT, 1=HALF, 2=FLOAT
};

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool ok = true;

  bool avail(size_t k) const { return pos + k <= n; }

  template <typename T>
  T read() {
    T v{};
    if (!avail(sizeof(T))) { const_cast<Reader*>(this)->ok = false; return v; }
    std::memcpy(&v, p + pos, sizeof(T));
    pos += sizeof(T);
    return v;
  }

  std::string cstring() {
    std::string s;
    while (pos < n && p[pos] != 0) s.push_back(static_cast<char>(p[pos++]));
    if (pos < n) ++pos;  // skip NUL
    else ok = false;
    return s;
  }

  void skip(size_t k) {
    if (!avail(k)) { ok = false; return; }
    pos += k;
  }
};

float half_to_float(uint16_t h) {
  uint32_t sign = (h >> 15) & 1u;
  uint32_t exp = (h >> 10) & 0x1fu;
  uint32_t man = h & 0x3ffu;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign << 31;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((man & 0x400u) == 0) { man <<= 1; --exp; }
      man &= 0x3ffu;
      f = (sign << 31) | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    f = (sign << 31) | 0x7f800000u | (man << 13);
  } else {
    f = (sign << 31) | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

// OpenEXR zip post-inflate transform: delta-decode then de-interleave.
void unpredict(std::vector<uint8_t>& buf) {
  const size_t n = buf.size();
  if (n == 0) return;
  for (size_t i = 1; i < n; ++i) {
    buf[i] = static_cast<uint8_t>(buf[i - 1] + buf[i] - 128);
  }
  std::vector<uint8_t> out(n);
  const size_t half = (n + 1) / 2;
  size_t a = 0, b = half, o = 0;
  while (o < n) {
    out[o++] = buf[a++];
    if (o < n) out[o++] = buf[b++];
  }
  buf.swap(out);
}

}  // namespace

extern "C" {

// Parse header only: fills width/height/num_channels and channel metadata.
// channel_names: caller-provided buffer of num x 32 bytes (nul-terminated);
// channel_types: int per channel. Returns 0 on success.
int exr_probe(const uint8_t* data, int64_t size, int32_t* width,
              int32_t* height, int32_t* num_channels,
              char* channel_names, int32_t max_channels,
              int32_t* channel_types, int32_t* compression) {
  Reader r{data, static_cast<size_t>(size)};
  if (r.read<int32_t>() != kMagic) return -1;
  int32_t version = r.read<int32_t>();
  if (version & 0x200) return -2;  // tiled

  std::vector<Channel> channels;
  int comp = -1;
  int32_t xmin = 0, ymin = 0, xmax = -1, ymax = -1;
  while (r.ok) {
    if (r.pos < r.n && data[r.pos] == 0) { r.skip(1); break; }
    std::string name = r.cstring();
    std::string type = r.cstring();
    int32_t attr_size = r.read<int32_t>();
    if (!r.ok || !r.avail(attr_size)) return -3;
    size_t attr_pos = r.pos;
    if (name == "channels") {
      Reader cr{data + attr_pos, static_cast<size_t>(attr_size)};
      while (cr.ok && cr.pos < cr.n && cr.p[cr.pos] != 0) {
        Channel ch;
        ch.name = cr.cstring();
        ch.pixel_type = cr.read<int32_t>();
        cr.skip(12);  // pLinear(1)+reserved(3)+xSampling(4)+ySampling(4)
        channels.push_back(ch);
      }
    } else if (name == "compression") {
      comp = data[attr_pos];
    } else if (name == "dataWindow") {
      Reader br{data + attr_pos, static_cast<size_t>(attr_size)};
      xmin = br.read<int32_t>();
      ymin = br.read<int32_t>();
      xmax = br.read<int32_t>();
      ymax = br.read<int32_t>();
    }
    r.pos = attr_pos + attr_size;
  }
  if (!r.ok || channels.empty() || comp < 0) return -4;
  if (comp != 0 && comp != 2 && comp != 3) return -5;  // none/zips/zip only

  *width = xmax - xmin + 1;
  *height = ymax - ymin + 1;
  *num_channels = static_cast<int32_t>(channels.size());
  *compression = comp;
  for (int i = 0; i < static_cast<int>(channels.size()) && i < max_channels;
       ++i) {
    std::snprintf(channel_names + 32 * i, 32, "%s", channels[i].name.c_str());
    channel_types[i] = channels[i].pixel_type;
  }
  return 0;
}

// Decode all channels into planar float32 `out` [num_channels, height, width]
// in file channel order. Returns 0 on success.
int exr_decode(const uint8_t* data, int64_t size, float* out) {
  int32_t width, height, num_channels, comp;
  char names[64 * 32];
  int32_t types[64];
  int rc = exr_probe(data, size, &width, &height, &num_channels, names, 64,
                     types, &comp);
  if (rc != 0) return rc;
  if (num_channels > 64) return -6;

  // Re-walk the header to find the end position (and dataWindow ymin).
  int32_t ymin = 0;
  Reader r{data, static_cast<size_t>(size)};
  r.skip(8);
  while (r.ok) {
    if (r.pos < r.n && data[r.pos] == 0) { r.skip(1); break; }
    std::string name = r.cstring();
    r.cstring();
    int32_t attr_size = r.read<int32_t>();
    if (name == "dataWindow" && r.avail(attr_size) && attr_size >= 8) {
      std::memcpy(&ymin, data + r.pos + 4, 4);
    }
    r.skip(attr_size);
  }
  if (!r.ok) return -7;

  const int lines_per_chunk = (comp == 3) ? 16 : 1;
  const int num_chunks = (height + lines_per_chunk - 1) / lines_per_chunk;
  r.skip(8 * static_cast<size_t>(num_chunks));  // offset table

  size_t bytes_per_px[64];
  size_t line_bytes = 0;
  for (int c = 0; c < num_channels; ++c) {
    bytes_per_px[c] = (types[c] == 1) ? 2 : 4;
    line_bytes += static_cast<size_t>(width) * bytes_per_px[c];
  }

  std::vector<uint8_t> chunk;
  for (int k = 0; k < num_chunks; ++k) {
    int32_t y = r.read<int32_t>();
    int32_t csize = r.read<int32_t>();
    if (!r.ok || !r.avail(csize)) return -8;
    const uint8_t* cdata = data + r.pos;
    r.skip(csize);

    const int y0 = y - ymin;
    const int n_lines = std::min(lines_per_chunk, height - y0);
    const size_t expect = line_bytes * static_cast<size_t>(n_lines);

    const uint8_t* src;
    if (comp != 0 && static_cast<size_t>(csize) != expect) {
      chunk.resize(expect);
      uLongf dst_len = expect;
      if (uncompress(chunk.data(), &dst_len, cdata, csize) != Z_OK ||
          dst_len != expect) {
        return -9;
      }
      unpredict(chunk);
      src = chunk.data();
    } else {
      src = cdata;
    }

    size_t off = 0;
    for (int line = 0; line < n_lines; ++line) {
      const int row = y0 + line;
      for (int c = 0; c < num_channels; ++c) {
        float* dst = out + (static_cast<size_t>(c) * height + row) * width;
        if (types[c] == 1) {
          const uint16_t* hp = reinterpret_cast<const uint16_t*>(src + off);
          for (int x = 0; x < width; ++x) dst[x] = half_to_float(hp[x]);
        } else if (types[c] == 2) {
          std::memcpy(dst, src + off, static_cast<size_t>(width) * 4);
        } else {  // UINT
          const uint32_t* up = reinterpret_cast<const uint32_t*>(src + off);
          for (int x = 0; x < width; ++x) dst[x] = static_cast<float>(up[x]);
        }
        off += static_cast<size_t>(width) * bytes_per_px[c];
      }
    }
  }
  return 0;
}

}  // extern "C"
