// tpuvr native volume codec + image writer.
//
// TPU-native counterpart of the reference renderer's C/C++ volume loader
// and framebuffer writer (reconstructed src/volume*, SURVEY.md §2.1): the
// host-side IO that should not run through Python loops. Exposed to
// Python via ctypes (no pybind11 in this image).
//
// TVOL format (little-endian):
//   magic   "TVOL0001"                     (8 bytes)
//   u32     zdim, ydim, xdim, channels
//   u32     codec        0 = raw f32, 1 = zero-RLE f32
//   u64     payload_bytes
//   payload
//
// Zero-RLE: volumes are mostly empty space; runs of exactly-0.0f values
// compress as (u32 0xFFFFFFFF, u32 run_length); literal spans as
// (u32 count, count * f32). Exact (bit-preserving) for f32.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Packed so the on-disk layout matches the pure-numpy fallback
// (8 magic + 5*u32 + u64 = 36 bytes, no padding).
#pragma pack(push, 1)
struct TvolHeader {
  char magic[8];
  uint32_t zdim, ydim, xdim, channels;
  uint32_t codec;
  uint64_t payload_bytes;
};
#pragma pack(pop)

static const char kMagic[8] = {'T', 'V', 'O', 'L', '0', '0', '0', '1'};
static const uint32_t kRunMarker = 0xFFFFFFFFu;

// Returns 0 on success.
int tvol_write(const char* path, const float* data, uint32_t zdim,
               uint32_t ydim, uint32_t xdim, uint32_t channels,
               int use_rle) {
  const uint64_t n = (uint64_t)zdim * ydim * xdim * channels;
  std::vector<uint8_t> payload;
  uint32_t codec = 0;
  if (use_rle) {
    codec = 1;
    payload.reserve(n);  // best case far smaller; grows as needed
    uint64_t i = 0;
    while (i < n) {
      if (data[i] == 0.0f) {
        uint64_t j = i;
        while (j < n && data[j] == 0.0f) ++j;
        uint64_t run = j - i;
        while (run > 0) {
          uint32_t chunk = run > 0xFFFFFFF0ull ? 0xFFFFFFF0u : (uint32_t)run;
          uint32_t words[2] = {kRunMarker, chunk};
          const uint8_t* p = (const uint8_t*)words;
          payload.insert(payload.end(), p, p + 8);
          run -= chunk;
        }
        i = j;
      } else {
        uint64_t j = i;
        while (j < n && data[j] != 0.0f) ++j;
        uint64_t lit = j - i;
        uint64_t k = i;
        while (lit > 0) {
          uint32_t chunk = lit > 0x0FFFFFFFull ? 0x0FFFFFFFu : (uint32_t)lit;
          const uint8_t* c = (const uint8_t*)&chunk;
          payload.insert(payload.end(), c, c + 4);
          const uint8_t* p = (const uint8_t*)(data + k);
          payload.insert(payload.end(), p, p + (uint64_t)chunk * 4);
          lit -= chunk;
          k += chunk;
        }
        i = j;
      }
    }
  } else {
    const uint8_t* p = (const uint8_t*)data;
    payload.assign(p, p + n * 4);
  }

  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  TvolHeader h;
  memcpy(h.magic, kMagic, 8);
  h.zdim = zdim; h.ydim = ydim; h.xdim = xdim; h.channels = channels;
  h.codec = codec;
  h.payload_bytes = payload.size();
  if (fwrite(&h, sizeof(h), 1, f) != 1) { fclose(f); return 2; }
  if (!payload.empty() &&
      fwrite(payload.data(), 1, payload.size(), f) != payload.size()) {
    fclose(f); return 3;
  }
  fclose(f);
  return 0;
}

// Reads the header; returns 0 on success.
int tvol_read_header(const char* path, uint32_t* dims_out /* z,y,x,c */) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  TvolHeader h;
  if (fread(&h, sizeof(h), 1, f) != 1 || memcmp(h.magic, kMagic, 8) != 0) {
    fclose(f); return 2;
  }
  dims_out[0] = h.zdim; dims_out[1] = h.ydim;
  dims_out[2] = h.xdim; dims_out[3] = h.channels;
  fclose(f);
  return 0;
}

// Decodes the full volume into out (caller-allocated, z*y*x*c floats).
int tvol_read(const char* path, float* out, uint64_t out_count) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  TvolHeader h;
  if (fread(&h, sizeof(h), 1, f) != 1 || memcmp(h.magic, kMagic, 8) != 0) {
    fclose(f); return 2;
  }
  const uint64_t n = (uint64_t)h.zdim * h.ydim * h.xdim * h.channels;
  if (n != out_count) { fclose(f); return 3; }
  std::vector<uint8_t> payload(h.payload_bytes);
  if (h.payload_bytes &&
      fread(payload.data(), 1, h.payload_bytes, f) != h.payload_bytes) {
    fclose(f); return 4;
  }
  fclose(f);
  if (h.codec == 0) {
    if (h.payload_bytes != n * 4) return 5;
    memcpy(out, payload.data(), n * 4);
    return 0;
  }
  if (h.codec != 1) return 6;
  uint64_t pos = 0, oi = 0;
  while (pos + 4 <= h.payload_bytes && oi < n) {
    uint32_t word;
    memcpy(&word, payload.data() + pos, 4);
    pos += 4;
    if (word == kRunMarker) {
      uint32_t run;
      if (pos + 4 > h.payload_bytes) return 7;
      memcpy(&run, payload.data() + pos, 4);
      pos += 4;
      if (oi + run > n) return 8;
      memset(out + oi, 0, (uint64_t)run * 4);
      oi += run;
    } else {
      uint64_t bytes = (uint64_t)word * 4;
      if (pos + bytes > h.payload_bytes || oi + word > n) return 9;
      memcpy(out + oi, payload.data() + pos, bytes);
      pos += bytes;
      oi += word;
    }
  }
  return oi == n ? 0 : 10;
}

// Binary PPM (P6) writer from float RGB in [0,1] with gamma encode.
int ppm_write(const char* path, const float* rgb, uint32_t height,
              uint32_t width, float inv_gamma) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  fprintf(f, "P6\n%u %u\n255\n", width, height);
  std::vector<uint8_t> row((uint64_t)width * 3);
  for (uint32_t y = 0; y < height; ++y) {
    const float* src = rgb + (uint64_t)y * width * 3;
    for (uint64_t i = 0; i < (uint64_t)width * 3; ++i) {
      float v = src[i];
      if (v < 0.0f) v = 0.0f;
      if (v > 1.0f) v = 1.0f;
      // gamma encode
      float g = 1.0f;
      if (v > 0.0f) {
        g = __builtin_powf(v, inv_gamma);
      } else {
        g = 0.0f;
      }
      int b = (int)(g * 255.0f + 0.5f);
      row[i] = (uint8_t)(b < 0 ? 0 : (b > 255 ? 255 : b));
    }
    if (fwrite(row.data(), 1, row.size(), f) != row.size()) {
      fclose(f); return 2;
    }
  }
  fclose(f);
  return 0;
}

}  // extern "C"
