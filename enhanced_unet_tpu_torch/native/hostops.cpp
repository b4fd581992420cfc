// Native host ops for the evaluation pipeline.
//
// The reference leans on pycocotools' C extension for RLE (train_eval.py:956)
// and numpy double loops for instance IoU (metrics.py:92-107).  This library
// provides the equivalent hot host paths in C++:
//   - column-major RLE run extraction / reconstruction (COCO semantics)
//   - pairwise mask IoU over packed 64-bit bitsets (AND + popcount), used by
//     greedy instance matching and the segm-mAP evaluator
//
// Exposed with a plain C ABI for ctypes.  A copy of the JAX package's
// native/hostops.cpp; `enhanced_unet_tpu_torch.native` builds it with
// g++ -O3 -shared -fPIC into build/hostops/ at first use.

#include <cstdint>
#include <cstring>

extern "C" {

// Column-major run lengths of a binary HxW mask, first run counts zeros.
// Returns the number of counts written, or -1 if max_counts is too small.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   int64_t* counts, int64_t max_counts) {
    const int64_t n = h * w;
    int64_t m = 0;
    uint8_t prev = 0;             // RLE starts with a zero-run
    int64_t run = 0;
    for (int64_t x = 0; x < w; ++x) {
        const uint8_t* col = mask + x;   // row-major input, walk column-major
        for (int64_t y = 0; y < h; ++y) {
            uint8_t v = col[y * w] > 0 ? 1 : 0;
            if (v == prev) {
                ++run;
            } else {
                if (m >= max_counts) return -1;
                counts[m++] = run;
                prev = v;
                run = 1;
            }
        }
    }
    if (m >= max_counts) return -1;
    counts[m++] = run;
    (void)n;
    return m;
}

// Reconstruct a binary HxW (row-major out) mask from column-major runs.
void rle_decode(const int64_t* counts, int64_t n_counts,
                uint8_t* out, int64_t h, int64_t w) {
    std::memset(out, 0, (size_t)(h * w));
    int64_t pos = 0;                 // column-major linear index
    uint8_t v = 0;
    const int64_t total = h * w;
    for (int64_t i = 0; i < n_counts && pos < total; ++i) {
        int64_t run = counts[i];
        if (v) {
            int64_t end = pos + run;
            if (end > total) end = total;
            for (int64_t p = pos; p < end; ++p) {
                int64_t y = p % h, x = p / h;
                out[y * w + x] = 1;
            }
        }
        pos += run;
        v ^= 1;
    }
}

// Pack n row-major binary masks of h*w pixels into 64-bit words.
// words_per_mask = ceil(h*w / 64); out has n * words_per_mask entries.
void pack_masks(const uint8_t* masks, int64_t n, int64_t px,
                uint64_t* out, int64_t words) {
    std::memset(out, 0, (size_t)(n * words * 8));
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* m = masks + i * px;
        uint64_t* o = out + i * words;
        for (int64_t p = 0; p < px; ++p) {
            if (m[p]) o[p >> 6] |= (uint64_t)1 << (p & 63);
        }
    }
}

// Pairwise IoU between two packed mask sets: out[i*nb + j].
// Empty-vs-empty pairs get IoU 0 (callers handle the convention).
void mask_iou_packed(const uint64_t* a, int64_t na,
                     const uint64_t* b, int64_t nb,
                     int64_t words, double* out) {
    // precompute areas
    for (int64_t i = 0; i < na; ++i) {
        const uint64_t* ai = a + i * words;
        int64_t area_i = 0;
        for (int64_t wd = 0; wd < words; ++wd)
            area_i += __builtin_popcountll(ai[wd]);
        for (int64_t j = 0; j < nb; ++j) {
            const uint64_t* bj = b + j * words;
            int64_t inter = 0, area_j = 0;
            for (int64_t wd = 0; wd < words; ++wd) {
                inter += __builtin_popcountll(ai[wd] & bj[wd]);
                area_j += __builtin_popcountll(bj[wd]);
            }
            int64_t uni = area_i + area_j - inter;
            out[i * nb + j] = uni > 0 ? (double)inter / (double)uni : 0.0;
        }
    }
}

}  // extern "C"
