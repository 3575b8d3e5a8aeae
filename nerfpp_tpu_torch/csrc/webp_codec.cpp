// WebP on the host: the VP8 (lossy) decoder to Y, U and V planes, the VP8L
// (lossless) decoder to ARGB, the ALPH chunk to an alpha plane, a VP8L
// encoder, and the image libwebp's lossless encoder writes in place of one
// with fully transparent pixels (the colour under alpha 0 rewritten).
// Built with g++ (-ffp-contract=off -fopenmp) at first use by
// nerfpp_tpu_torch/native.py build_library and loaded with ctypes
// (utils/webp.py); plain C interface.
//
// The decoders follow RFC 6386 (VP8) and RFC 9649 (VP8L) as libwebp decodes
// them, step for step where a choice shows in the pixels: libwebp's boolean
// decoder, its token parsing and coefficient dequantisation, its intra
// predictors with the 127 / 129 borders, its inverse WHT and DCT, and its
// loop filters applied in macroblock raster order after the frame is
// reconstructed (intra prediction reads the unfiltered pixels). The chroma
// upsampling and YUV -> RGB conversion are the device stage in utils/webp.py.
//
// Return codes: >= 0 success (the encoder: bytes written), -1 a bitstream
// error, -2 data that ends too soon, -3 no room for the output.
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

namespace {

enum { ERR_BITSTREAM = -1, ERR_DATA = -2, ERR_ROOM = -3 };

// ------------------------------------------------------------------ tables
// RFC 6386 section 13.5 (default coefficient probabilities), 13.4 (their
// update probabilities), 11.5 (key-frame sub-block mode probabilities, in
// libwebp's mode order DC, TM, VE, HE, RD, VR, LD, VL, HD, HU), 14.1
// (quantiser steps); RFC 9649 section 4.2.2 (distance codes to (dx, dy)),
// each flattened row-major over the dimensions named in the comment.
// [4 block types][8 bands][3 contexts][11 tree probabilities]
const uint8_t kCoeffsProba0[1056] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// [4 block types][8 bands][3 contexts][11 tree probabilities]
const uint8_t kCoeffsUpdateProba[1056] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// [10 modes above][10 modes on the left][9 tree probabilities]
const uint8_t kBModesProba[900] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};
// [128 quantiser indices]
const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
// [128 quantiser indices]
const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// [120 distance codes]: (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
  24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
  56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
  71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
  75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
  68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
  102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
  120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
  118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
  0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
  81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's sub-block modes; the 16x16 and chroma modes share the first four
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED,
       H_PRED = B_HE_PRED };

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------- boolean decoder
// libwebp's VP8BitReader, loading one byte at a time: range_ holds range - 1,
// and past the end of the data one zero byte is shifted in and eof is set.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* b, size_t n) {
    buf = b;
    end = b + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // a bit at probability 1/2 as the sign of v (libwebp's VP8GetSigned)
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = (int)get_value(n);
    return bit(0x80) ? -v : v;
  }
};

// -------------------------------------------------------------- VP8 lossy
const int BPS = 32;  // the work area's stride, as libwebp's

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int seg_probs[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  int num_parts = 1;
  BoolReader br, parts[8];
  int y1[4][2], y2[4][2], uv[4][2];  // dequantisation per segment (dc, ac)
  uint8_t proba[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  FInfo fstrengths[4][2];
};

// one macroblock's parsed modes and coefficients
struct MB {
  int16_t coeffs[384];
  uint8_t imodes[16];
  int is_i4x4, uvmode, segment, skip;
};

void parse_intra_mode(Vp8& d, MB& b, uint8_t* top, uint8_t* left) {
  BoolReader& br = d.br;
  if (d.update_map) {
    b.segment = !br.bit(d.seg_probs[0]) ? br.bit(d.seg_probs[1])
                                        : br.bit(d.seg_probs[2]) + 2;
  } else {
    b.segment = 0;
  }
  b.skip = d.use_skip ? br.bit(d.skip_p) : 0;
  b.is_i4x4 = !br.bit(145);
  if (!b.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                  : (br.bit(163) ? V_PRED : DC_PRED);
    b.imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = b.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* p = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !br.bit(p[0]) ? B_DC_PRED
              : !br.bit(p[1]) ? B_TM_PRED
              : !br.bit(p[2]) ? B_VE_PRED
              : !br.bit(p[3])
                  ? (!br.bit(p[4]) ? B_HE_PRED
                                   : (!br.bit(p[5]) ? B_RD_PRED : B_VR_PRED))
                  : (!br.bit(p[6]) ? B_LD_PRED
                                   : (!br.bit(p[7]) ? B_VL_PRED
                                                    : (!br.bit(p[8]) ? B_HD_PRED
                                                                     : B_HU_PRED)));
        top[x] = (uint8_t)ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  b.uvmode = !br.bit(142) ? DC_PRED
           : !br.bit(114) ? V_PRED
           : br.bit(183) ? TM_PRED : H_PRED;
}

int get_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.bit(p[5]);
    }
  } else {
    if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) {
        v += v + br.bit(*tab);
      }
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// one block's coefficients from position ``n`` on, dequantised by ``dq``
// (dc, ac) into ``out`` in raster order: the position of the last non-zero
// coefficient plus one (libwebp's GetCoeffs), under the probabilities of
// one block type, band by band, and context ``ctx`` for the first
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = get_large_value(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// returns 1 when every coefficient of the macroblock is zero
int parse_residuals(Vp8& d, MB& b, uint8_t& top_nz, uint8_t& top_nz_dc,
                    uint8_t& left_nz, uint8_t& left_nz_dc, BoolReader& br) {
  const int* y1 = d.y1[b.segment];
  const int* y2 = d.y2[b.segment];
  const int* uvq = d.uv[b.segment];
  int16_t* dst = b.coeffs;
  memset(dst, 0, sizeof(b.coeffs));
  int first;
  const uint8_t (*ac_proba)[3][11];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  if (!b.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top_nz_dc + left_nz_dc;
    const int nz = get_coeffs(br, d.proba[1], ctx, y2, 0, dc);
    top_nz_dc = left_nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = d.proba[0];
  } else {
    first = 0;
    ac_proba = d.proba[3];
  }
  uint32_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nzc = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, y1, first, dst);
      l = nz > first;
      tnz = (tnz >> 1) | (l << 7);
      nzc = (nzc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nzc;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nzc = 0;
    tnz = top_nz >> (4 + ch);
    lnz = left_nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, d.proba[2], ctx, uvq, 0, dst);
        l = nz > 0;
        tnz = (tnz >> 1) | (l << 3);
        nzc = (nzc << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nzc << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  top_nz = (uint8_t)out_t_nz;
  left_nz = (uint8_t)out_l_nz;
  return !(non_zero_y | non_zero_uv);
}

// -------- reconstruction (dst points into a work area of stride BPS)
#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int c[16];
  int* tmp = c;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int cc = mul2(in[4]) - mul1(in[12]);
    const int dd = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + dd;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - dd;
    tmp += 4;
    in++;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int cc = mul2(tmp[4]) - mul1(tmp[12]);
    const int dd = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + dd) >> 3));
    dst[1] = clip8(dst[1] + ((b + cc) >> 3));
    dst[2] = clip8(dst[2] + ((b - cc) >> 3));
    dst[3] = clip8(dst[3] + ((a - dd) >> 3));
    tmp++;
    dst += BPS;
  }
}

void add_block(const int16_t* in, uint8_t* dst) {
  for (int i = 0; i < 16; ++i) {
    if (in[i]) {
      transform_one(in, dst);
      return;
    }
  }
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[y * BPS - 1];
    for (int x = 0; x < size; ++x) dst[y * BPS + x] = clip8(top[x] + l - tl);
  }
}

void pred_square(uint8_t* dst, int size, int mode, int has_top,
                 int has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc;
      int st = 0, sl = 0;
      for (int j = 0; j < size; ++j) {
        st += dst[j - BPS];
        sl += dst[j * BPS - 1];
      }
      if (has_top && has_left) {
        dc = (st + sl + size) >> (shift + 1);
      } else if (has_left) {
        dc = (sl + (size >> 1)) >> shift;
      } else if (has_top) {
        dc = (st + (size >> 1)) >> shift;
      } else {
        dc = 0x80;
      }
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dc, size);
      break;
    }
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
      break;
    default:  // H_PRED
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
  }
}

void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS];
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, (int)dc, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                               AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst + 0 * BPS, AVG3(X, I, J), 4);
      memset(dst + 1 * BPS, AVG3(I, J, K), 4);
      memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_LD_PRED:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VL_PRED:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = L;
      break;
  }
}

// a macroblock's work areas, each with a row above and columns on the left
struct Work {
  uint8_t y[BPS * 17], u[BPS * 9], v[BPS * 9];
};

// the borders of macroblock (mbx, mby) of a plane of ``stride`` in its work
// area, as libwebp sets them: the row above (127 on the first macroblock
// row), the column on the left (129 on the first macroblock column), the
// corner (127 on the first row, else 129 on the first column), and for luma
// the four pixels above-right (the last pixel above, repeated, on the last
// macroblock column)
void load_borders(uint8_t* dst, const uint8_t* plane, int stride, int size,
                  int mbx, int mby, int mb_w, bool luma) {
  const int px = mbx * size, py = mby * size;
  uint8_t* top = dst - BPS;
  if (mby == 0) {
    memset(top - 1, 127, size + 1 + (luma ? 4 : 0));
  } else {
    top[-1] = mbx == 0 ? 129 : plane[(py - 1) * stride + px - 1];
    memcpy(top, plane + (py - 1) * stride + px, size);
    if (luma) {
      if (mbx >= mb_w - 1) {
        memset(top + 16, plane[(py - 1) * stride + px + 15], 4);
      } else {
        memcpy(top + 16, plane + (py - 1) * stride + px + 16, 4);
      }
    }
  }
  for (int j = 0; j < size; ++j) {
    dst[j * BPS - 1] = mbx == 0 ? 129 : plane[(py + j) * stride + px - 1];
  }
}

void store(const uint8_t* src, uint8_t* plane, int stride, int size, int mbx,
           int mby) {
  for (int j = 0; j < size; ++j) {
    memcpy(plane + (mby * size + j) * stride + mbx * size, src + j * BPS, size);
  }
}

void reconstruct(const Vp8& d, const MB& b, int mbx, int mby, uint8_t* Y,
                 uint8_t* U, uint8_t* V, Work& w) {
  const int ys = d.mb_w * 16, uvs = d.mb_w * 8;
  uint8_t* yd = w.y + BPS + 8;
  uint8_t* ud = w.u + BPS + 8;
  uint8_t* vd = w.v + BPS + 8;
  load_borders(yd, Y, ys, 16, mbx, mby, d.mb_w, true);
  load_borders(ud, U, uvs, 8, mbx, mby, d.mb_w, false);
  load_borders(vd, V, uvs, 8, mbx, mby, d.mb_w, false);
  if (b.is_i4x4) {
    uint8_t* tr = yd - BPS + 16;
    memcpy(tr + 4 * BPS, tr, 4);
    memcpy(tr + 8 * BPS, tr, 4);
    memcpy(tr + 12 * BPS, tr, 4);
    for (int n = 0; n < 16; ++n) {
      uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
      pred4(dst, b.imodes[n]);
      add_block(b.coeffs + n * 16, dst);
    }
  } else {
    pred_square(yd, 16, b.imodes[0], mby > 0, mbx > 0);
    for (int n = 0; n < 16; ++n) {
      add_block(b.coeffs + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
  }
  pred_square(ud, 8, b.uvmode, mby > 0, mbx > 0);
  pred_square(vd, 8, b.uvmode, mby > 0, mbx > 0);
  for (int n = 0; n < 4; ++n) {
    const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
    add_block(b.coeffs + 256 + n * 16, ud + off);
    add_block(b.coeffs + 320 + n * 16, vd + off);
  }
  store(yd, Y, ys, 16, mbx, mby);
  store(ud, U, uvs, 8, mbx, mby);
  store(vd, V, uvs, 8, mbx, mby);
}

// ------------------------------------------------------------ loop filter
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * vstride, hstride, thresh2)) {
      do_filter2(p + i * vstride, hstride);
    }
  }
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_mb(const Vp8& d, const FInfo& f, int mbx, int mby, uint8_t* Y,
               uint8_t* U, uint8_t* V) {
  const int limit = f.limit;
  if (limit == 0) return;
  const int ys = d.mb_w * 16, uvs = d.mb_w * 8;
  uint8_t* yd = Y + mby * 16 * ys + mbx * 16;
  if (d.filter_type == 1) {
    if (mbx > 0) simple_filter(yd, 1, ys, limit + 4);
    if (f.inner) {
      for (int k = 1; k < 4; ++k) simple_filter(yd + 4 * k, 1, ys, limit);
    }
    if (mby > 0) simple_filter(yd, ys, 1, limit + 4);
    if (f.inner) {
      for (int k = 1; k < 4; ++k) simple_filter(yd + 4 * k * ys, ys, 1, limit);
    }
    return;
  }
  uint8_t* ud = U + mby * 8 * uvs + mbx * 8;
  uint8_t* vd = V + mby * 8 * uvs + mbx * 8;
  const int il = f.ilevel, ht = f.hev_thresh;
  if (mbx > 0) {
    filter_loop(yd, 1, ys, 16, limit + 4, il, ht, true);
    filter_loop(ud, 1, uvs, 8, limit + 4, il, ht, true);
    filter_loop(vd, 1, uvs, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) {
      filter_loop(yd + 4 * k, 1, ys, 16, limit, il, ht, false);
    }
    filter_loop(ud + 4, 1, uvs, 8, limit, il, ht, false);
    filter_loop(vd + 4, 1, uvs, 8, limit, il, ht, false);
  }
  if (mby > 0) {
    filter_loop(yd, ys, 1, 16, limit + 4, il, ht, true);
    filter_loop(ud, uvs, 1, 8, limit + 4, il, ht, true);
    filter_loop(vd, uvs, 1, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) {
      filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
    }
    filter_loop(ud + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    filter_loop(vd + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
  }
}

void precompute_filter_strengths(Vp8& d) {
  if (d.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d.use_segment) {
      base_level = d.filter_strength[s];
      if (!d.absolute_delta) base_level += d.level;
    } else {
      base_level = d.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = d.fstrengths[s][i4x4];
      int level = base_level;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = clip(level, 63);
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

int parse_headers(Vp8& d, const uint8_t* data, size_t size) {
  if (size < 10) return ERR_DATA;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame || profile > 3 || !show) return ERR_BITSTREAM;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) {
    return ERR_BITSTREAM;
  }
  d.width = ((data[7] << 8) | data[6]) & 0x3fff;
  d.height = ((data[9] << 8) | data[8]) & 0x3fff;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  if (partition_length > buf_size) return ERR_DATA;
  BoolReader& br = d.br;
  br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  br.get_value(1);  // colour space
  br.get_value(1);  // clamping type
  // segment header
  d.use_segment = br.get_value(1);
  if (d.use_segment) {
    d.update_map = br.get_value(1);
    if (br.get_value(1)) {
      d.absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s) {
        d.quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      }
      for (int s = 0; s < 4; ++s) {
        d.filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
      }
    }
    if (d.update_map) {
      for (int s = 0; s < 3; ++s) {
        d.seg_probs[s] = br.get_value(1) ? (int)br.get_value(8) : 255;
      }
    }
  } else {
    d.update_map = 0;
  }
  if (br.eof) return ERR_BITSTREAM;
  // filter header
  d.simple = br.get_value(1);
  d.level = br.get_value(6);
  d.sharpness = br.get_value(3);
  d.use_lf_delta = br.get_value(1);
  if (d.use_lf_delta && br.get_value(1)) {
    for (int i = 0; i < 4; ++i) {
      if (br.get_value(1)) d.ref_lf_delta[i] = br.get_signed_value(6);
    }
    for (int i = 0; i < 4; ++i) {
      if (br.get_value(1)) d.mode_lf_delta[i] = br.get_signed_value(6);
    }
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) return ERR_BITSTREAM;
  // token partitions
  const int last_part = (1 << br.get_value(2)) - 1;
  d.num_parts = last_part + 1;
  if (buf_size < 3 * (size_t)last_part) return ERR_DATA;
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  const uint8_t* buf_end = buf + buf_size;
  size_t size_left = buf_size - last_part * 3;
  for (int p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  d.parts[last_part].init(part_start, size_left);
  if (part_start >= buf_end) return ERR_DATA;
  // quantisers
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i];
      if (!d.absolute_delta) q += base_q0;
    } else {
      q = base_q0;
    }
    d.y1[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
    d.y1[i][1] = kAcTable[clip(q, 127)];
    d.y2[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    d.y2[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (d.y2[i][1] < 8) d.y2[i][1] = 8;
    d.uv[i][0] = kDcTable[clip(q + dquv_dc, 117)];
    d.uv[i][1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get_value(1);  // refresh the entropy probabilities (ignored)
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b) {
      for (int c = 0; c < 3; ++c) {
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          d.proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[i])
                                    ? (uint8_t)br.get_value(8)
                                    : kCoeffsProba0[i];
        }
      }
    }
  }
  d.use_skip = br.get_value(1);
  if (d.use_skip) d.skip_p = br.get_value(8);
  return 0;
}

// ----------------------------------------------------------- VP8L reader
struct LBitReader {
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  uint64_t val = 0;
  int nbits = 0;      // valid bits in val
  uint64_t used = 0;  // bits consumed

  void init(const uint8_t* b, size_t n) {
    buf = b;
    len = n;
    pos = 0;
    val = 0;
    nbits = 0;
    used = 0;
  }
  void fill() {
    while (nbits <= 56) {
      const uint64_t byte = pos < len ? buf[pos] : 0;
      ++pos;
      val |= byte << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(val & ((1ull << n) - 1));
  }
  void skip(int n) {
    val >>= n;
    nbits -= n;
    used += n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool eos() const { return used > 8ull * len; }
};

const int HUFF_FAST = 10;

// a canonical prefix code: a table on the first HUFF_FAST bits, and the
// code's counts and sorted symbols for longer codes
struct Huffman {
  int single = -1;  // the symbol of a one-symbol code (read in 0 bits)
  std::vector<uint16_t> fast;  // (symbol << 4) | length; length 0: longer
  int count[16] = {0};
  std::vector<uint16_t> sorted;

  // 0 if the lengths are not a complete code (libwebp's rule), else 1
  int build(const uint8_t* lengths, int n) {
    int nonzero = 0;
    memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return 0;
      if (lengths[s]) {
        ++nonzero;
        ++count[lengths[s]];
      }
    }
    if (nonzero == 0) return 0;
    sorted.assign(nonzero, 0);
    int offs[17];
    offs[1] = 0;
    for (int l = 1; l < 16; ++l) offs[l + 1] = offs[l] + count[l];
    for (int s = 0; s < n; ++s) {
      if (lengths[s]) sorted[offs[lengths[s]]++] = (uint16_t)s;
    }
    if (nonzero == 1) {
      single = sorted[0];
      return 1;
    }
    single = -1;
    // completeness: the Kraft sum must be exactly one
    int64_t left = 1;
    for (int l = 1; l < 16; ++l) {
      left = left * 2 - count[l];
      if (left < 0) return 0;
    }
    if (left != 0) return 0;
    fast.assign(1 << HUFF_FAST, 0);
    int code = 0, idx = 0;
    for (int l = 1; l < 16; ++l) {
      for (int k = 0; k < count[l]; ++k, ++idx, ++code) {
        if (l <= HUFF_FAST) {
          int rev = 0;
          for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
          for (int f = rev; f < (1 << HUFF_FAST); f += 1 << l) {
            fast[f] = (uint16_t)((sorted[idx] << 4) | l);
          }
        }
      }
      code <<= 1;
    }
    return 1;
  }

  int read(LBitReader& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(16);
    const uint16_t e = fast[bits & ((1 << HUFF_FAST) - 1)];
    if (e & 15) {
      br.skip(e & 15);
      return e >> 4;
    }
    // the slow path: one bit at a time (puff's decode)
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= (bits >> (l - 1)) & 1;
      const int c = count[l];
      if (code - c < first) {
        br.skip(l);
        return sorted[index + (code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return -1;
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

int read_huffman_code(LBitReader& br, int alphabet_size, Huffman& h) {
  std::vector<uint8_t> lengths(std::max(alphabet_size, 256), 0);
  if (br.read(1)) {  // simple code
    const int num_symbols = br.read(1) + 1;
    const int first_len = br.read(1);
    int symbol = br.read(first_len == 0 ? 1 : 8);
    lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = br.read(8);
      lengths[symbol] = 1;
    }
  } else {
    uint8_t cl_lengths[19] = {0};
    const int num_codes = br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = br.read(3);
    Huffman cl;
    if (!cl.build(cl_lengths, 19)) return ERR_BITSTREAM;
    int max_symbol;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(length_nbits);
      if (max_symbol > alphabet_size) return ERR_BITSTREAM;
    } else {
      max_symbol = alphabet_size;
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet_size) {
      if (max_symbol-- == 0) break;
      const int code_len = cl.read(br);
      if (code_len < 0) return ERR_BITSTREAM;
      if (code_len < 16) {
        lengths[symbol++] = (uint8_t)code_len;
        if (code_len != 0) prev = code_len;
      } else {
        const int slot = code_len - 16;
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int repeat = br.read(extra[slot]) + offset[slot];
        if (symbol + repeat > alphabet_size) return ERR_BITSTREAM;
        const int length = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = (uint8_t)length;
      }
    }
  }
  if (br.eos()) return ERR_DATA;
  if (!h.build(lengths.data(), alphabet_size)) return ERR_BITSTREAM;
  return 0;
}

struct HGroup {
  Huffman h[5];
};

inline int prefix_value(int symbol, LBitReader& br) {
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + (int)br.read(extra_bits) + 1;
}

inline int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

inline uint32_t sub_sample(uint32_t size, int bits) {
  return (size + (1u << bits) - 1) >> bits;
}

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

int decode_image_stream(LBitReader& br, int xsize, int ysize, bool level0,
                        std::vector<uint32_t>& out,
                        std::vector<Transform>* transforms);

// the entropy-coded pixels of an image of xsize x ysize
int decode_pixels(LBitReader& br, int xsize, int ysize, int cache_bits,
                  const std::vector<HGroup>& groups,
                  const std::vector<uint32_t>& meta, int meta_bits,
                  int meta_xsize, std::vector<uint32_t>& out) {
  const size_t total = (size_t)xsize * ysize;
  out.assign(total, 0);
  std::vector<uint32_t> cache(cache_bits > 0 ? (1u << cache_bits) : 0, 0);
  const int cache_shift = 32 - cache_bits;
  size_t last_cached = 0;
  size_t pos = 0;
  int col = 0, row = 0;
  auto cache_upto = [&](size_t end) {
    if (cache_bits > 0) {
      while (last_cached < end) {
        const uint32_t c = out[last_cached++];
        cache[(0x1e35a7bdu * c) >> cache_shift] = c;
      }
    }
  };
  while (pos < total) {
    const HGroup& g = meta.empty()
        ? groups[0]
        : groups[meta[(size_t)meta_xsize * (row >> meta_bits) + (col >> meta_bits)]];
    const int code = g.h[0].read(br);
    if (code < 0) return ERR_BITSTREAM;
    if (code < 256) {
      const int red = g.h[1].read(br);
      const int blue = g.h[2].read(br);
      const int alpha = g.h[3].read(br);
      if (red < 0 || blue < 0 || alpha < 0) return ERR_BITSTREAM;
      out[pos++] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
      if (++col >= xsize) {
        col = 0;
        ++row;
        cache_upto(pos);
      }
    } else if (code < 256 + 24) {
      const int length = prefix_value(code - 256, br);
      const int dist_symbol = g.h[4].read(br);
      if (dist_symbol < 0) return ERR_BITSTREAM;
      const int dist_code = prefix_value(dist_symbol, br);
      const size_t dist = (size_t)plane_code_to_distance(xsize, dist_code);
      if (br.eos()) return ERR_DATA;
      if (pos < dist || total - pos < (size_t)length) return ERR_BITSTREAM;
      for (int i = 0; i < length; ++i) out[pos + i] = out[pos + i - dist];
      pos += length;
      col += length;
      while (col >= xsize) {
        col -= xsize;
        ++row;
      }
      cache_upto(pos);
    } else {
      const int key = code - 256 - 24;
      if (cache_bits == 0 || key >= (1 << cache_bits)) return ERR_BITSTREAM;
      cache_upto(pos);
      out[pos++] = cache[key];
      if (++col >= xsize) {
        col = 0;
        ++row;
        cache_upto(pos);
      }
    }
    if (br.eos()) return ERR_DATA;
  }
  return 0;
}

int read_transform(LBitReader& br, int& xsize, int ysize,
                   std::vector<Transform>& transforms, uint32_t& seen) {
  Transform t;
  t.type = br.read(2);
  if (seen & (1u << t.type)) return ERR_BITSTREAM;
  seen |= 1u << t.type;
  t.xsize = xsize;
  t.ysize = ysize;
  int err = 0;
  if (t.type == 0 || t.type == 1) {  // predictor, cross-colour
    t.bits = br.read(3) + 2;
    err = decode_image_stream(br, sub_sample(xsize, t.bits),
                              sub_sample(ysize, t.bits), false, t.data, nullptr);
  } else if (t.type == 3) {  // colour indexing
    const int num_colors = br.read(8) + 1;
    const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
    xsize = sub_sample(t.xsize, bits);
    t.bits = bits;
    std::vector<uint32_t> palette;
    err = decode_image_stream(br, num_colors, 1, false, palette, nullptr);
    if (!err) {
      const int final_num = 1 << (8 >> bits);
      t.data.assign(final_num, 0);
      uint8_t* dst = (uint8_t*)t.data.data();
      const uint8_t* src = (const uint8_t*)palette.data();
      for (int i = 0; i < 4 && i < 4 * num_colors; ++i) dst[i] = src[i];
      for (int i = 4; i < 4 * num_colors; ++i) dst[i] = (uint8_t)(src[i] + dst[i - 4]);
    }
  }
  transforms.push_back(std::move(t));
  return err;
}

int decode_image_stream(LBitReader& br, int xsize, int ysize, bool level0,
                        std::vector<uint32_t>& out,
                        std::vector<Transform>* transforms) {
  int txsize = xsize;
  if (level0) {
    uint32_t seen = 0;
    while (br.read(1)) {
      const int err = read_transform(br, txsize, ysize, *transforms, seen);
      if (err) return err;
      if (br.eos()) return ERR_DATA;
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return ERR_BITSTREAM;
  }
  std::vector<uint32_t> meta;
  int meta_bits = 0, meta_xsize = 0, num_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = br.read(3) + 2;
    meta_xsize = sub_sample(txsize, meta_bits);
    const int err = decode_image_stream(br, meta_xsize,
                                        sub_sample(ysize, meta_bits), false,
                                        meta, nullptr);
    if (err) return err;
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      num_groups = std::max(num_groups, (int)m + 1);
    }
  }
  if (br.eos()) return ERR_DATA;
  std::vector<HGroup> groups(num_groups);
  for (HGroup& g : groups) {
    for (int j = 0; j < 5; ++j) {
      int size = kAlphabetSize[j];
      if (j == 0 && cache_bits > 0) size += 1 << cache_bits;
      const int err = read_huffman_code(br, size, g.h[j]);
      if (err) return err;
    }
  }
  const int err = decode_pixels(br, txsize, ysize, cache_bits, groups, meta,
                                meta_bits, meta_xsize, out);
  if (err) return err;
  return br.eos() ? ERR_DATA : 0;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) {
  if (a < 256) return a;
  return ~a >> 24;
}

inline int add_sub_full(int a, int b, int c) {
  return (int)clip255((uint32_t)(a + b - c));
}

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const int a = add_sub_full(c0 >> 24, c1 >> 24, c2 >> 24);
  const int r = add_sub_full((c0 >> 16) & 0xff, (c1 >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_full((c0 >> 8) & 0xff, (c1 >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_full(c0 & 0xff, c1 & 0xff, c2 & 0xff);
  return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}

inline int add_sub_half(int a, int b) {
  return (int)clip255((uint32_t)(a + (a - b) / 2));
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = add_sub_half(ave >> 24, c2 >> 24);
  const int r = add_sub_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_sub_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_sub_half(ave & 0xff, c2 & 0xff);
  return ((uint32_t)a << 24) | (r << 16) | (g << 8) | b;
}

inline int sub3(int a, int b, int c) {
  const int pb = b - c;
  const int pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

// the prediction of mode ``mode`` at a pixel with left ``L`` and the row
// above at ``top`` (top[-1] above-left, top[1] above-right)
inline uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

inline int color_delta(int8_t pred, int8_t color) {
  return ((int)pred * color) >> 5;
}

void inverse_transform(const Transform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 2) {  // subtract green
    for (uint32_t& p : px) {
      const uint32_t green = (p >> 8) & 0xff;
      uint32_t rb = p & 0x00ff00ffu;
      rb += (green << 16) | green;
      rb &= 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
  } else if (t.type == 0) {  // predictor
    uint32_t* out = px.data();
    out[0] = add_pixels(out[0], 0xff000000u);
    for (int x = 1; x < w; ++x) out[x] = add_pixels(out[x], out[x - 1]);
    const int tiles = sub_sample(w, t.bits);
    for (int y = 1; y < h; ++y) {
      uint32_t* row = out + (size_t)y * w;
      const uint32_t* top = row - w;
      const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
      row[0] = add_pixels(row[0], top[0]);
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
      }
    }
  } else if (t.type == 1) {  // cross-colour
    const int tiles = sub_sample(w, t.bits);
    for (int y = 0; y < h; ++y) {
      uint32_t* row = px.data() + (size_t)y * w;
      const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles;
      for (int x = 0; x < w; ++x) {
        const uint32_t c = codes[x >> t.bits];
        const int8_t g2r = (int8_t)(c & 0xff), g2b = (int8_t)((c >> 8) & 0xff),
                     r2b = (int8_t)((c >> 16) & 0xff);
        const uint32_t argb = row[x];
        const int8_t green = (int8_t)(argb >> 8);
        int new_red = (argb >> 16) & 0xff;
        int new_blue = argb & 0xff;
        new_red += color_delta(g2r, green);
        new_red &= 0xff;
        new_blue += color_delta(g2b, green);
        new_blue += color_delta(r2b, (int8_t)new_red);
        new_blue &= 0xff;
        row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
      }
    }
  } else {  // colour indexing: px holds the packed image
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    const int packed_w = sub_sample(w, t.bits);
    std::vector<uint32_t> out((size_t)w * h);
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = px.data() + (size_t)y * packed_w;
      uint32_t* dst = out.data() + (size_t)y * w;
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
    px.swap(out);
  }
}

int vp8l_decode_stream(LBitReader& br, int w, int h, uint32_t* argb) {
  std::vector<Transform> transforms;
  std::vector<uint32_t> px;
  const int err = decode_image_stream(br, w, h, true, px, &transforms);
  if (err) return err;
  for (int i = (int)transforms.size() - 1; i >= 0; --i) {
    inverse_transform(transforms[i], px);
  }
  memcpy(argb, px.data(), (size_t)w * h * 4);
  return 0;
}

// ---------------------------------------------------------- alpha filters
inline uint8_t gradient_pred(int a, int b, int c) {
  const int g = a + b - c;
  return (uint8_t)((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255);
}

void unfilter_row(int filter, const uint8_t* prev, const uint8_t* in,
                  uint8_t* out, int width) {
  if (filter == 0) {
    memcpy(out, in, width);
  } else if (prev == nullptr || filter == 1) {  // horizontal
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = (uint8_t)(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
  } else {  // gradient
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      left = (uint8_t)(in[i] + gradient_pred(left, top, top_left));
      top_left = top;
      out[i] = left;
    }
  }
}

// ---------------------------------------------------------- VP8L writer
struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int bits) {
    if (bits == 0) return;
    acc |= (uint64_t)v << n;
    n += bits;
    while (n >= 8) {
      buf.push_back((uint8_t)acc);
      acc >>= 8;
      n -= 8;
    }
  }
  void finish() {
    if (n > 0) buf.push_back((uint8_t)acc);
    acc = 0;
    n = 0;
  }
};

// code lengths of at most ``limit`` bits for ``freq`` (Huffman's, with the
// counts halved until the longest code fits)
void code_lengths(const std::vector<uint32_t>& freq, int limit,
                  std::vector<uint8_t>& len) {
  const int n = (int)freq.size();
  len.assign(n, 0);
  std::vector<uint32_t> f(freq);
  for (;;) {
    std::vector<int> used;
    for (int i = 0; i < n; ++i) if (f[i]) used.push_back(i);
    if (used.size() <= 1) {
      if (used.size() == 1) len[used[0]] = 1;
      return;
    }
    // nodes: leaves then internal; a simple O(n log n) with a heap
    struct Node { uint64_t w; int id; };
    auto cmp = [](const Node& a, const Node& b) {
      return a.w != b.w ? a.w > b.w : a.id > b.id;
    };
    std::vector<Node> heap;
    std::vector<int> parent(2 * used.size(), -1);
    for (size_t k = 0; k < used.size(); ++k) heap.push_back({f[used[k]], (int)k});
    std::make_heap(heap.begin(), heap.end(), cmp);
    int next = (int)used.size();
    while (heap.size() > 1) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      Node a = heap.back();
      heap.pop_back();
      std::pop_heap(heap.begin(), heap.end(), cmp);
      Node b = heap.back();
      heap.pop_back();
      parent[a.id] = next;
      parent[b.id] = next;
      heap.push_back({a.w + b.w, next++});
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
    int maxlen = 0;
    for (size_t k = 0; k < used.size(); ++k) {
      int depth = 0;
      for (int p = (int)k; parent[p] >= 0; p = parent[p]) ++depth;
      len[used[k]] = (uint8_t)depth;
      maxlen = std::max(maxlen, depth);
    }
    if (maxlen <= limit) return;
    for (int i = 0; i < n; ++i) if (f[i]) f[i] = (f[i] + 1) >> 1;
    std::fill(len.begin(), len.end(), 0);
  }
}

// canonical codes from lengths, bit-reversed for the LSB-first stream
void canonical_codes(const std::vector<uint8_t>& len, std::vector<uint16_t>& codes) {
  const int n = (int)len.size();
  codes.assign(n, 0);
  int count[16] = {0};
  for (int i = 0; i < n; ++i) ++count[len[i]];
  count[0] = 0;
  int next[16] = {0};
  int code = 0;
  for (int l = 1; l < 16; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; ++i) {
    if (!len[i]) continue;
    const int c = next[len[i]]++;
    int rev = 0;
    for (int b = 0; b < len[i]; ++b) rev |= ((c >> b) & 1) << (len[i] - 1 - b);
    codes[i] = (uint16_t)rev;
  }
}

struct Code {
  std::vector<uint8_t> len;
  std::vector<uint16_t> codes;
  int single = 0;  // one symbol: written in 0 bits
  void put(BitWriter& bw, int sym) const {
    if (!single) bw.put(codes[sym], len[sym]);
  }
};

// writes the code for ``freq`` to the stream and returns it
Code write_code(BitWriter& bw, const std::vector<uint32_t>& freq) {
  Code c;
  code_lengths(freq, 15, c.len);
  std::vector<int> used;
  for (size_t i = 0; i < freq.size(); ++i) if (c.len[i]) used.push_back((int)i);
  if (used.size() <= 2 && (used.empty() || used.back() < 256)) {
    // simple code of one or two symbols below 256
    const int s0 = used.empty() ? 0 : used[0];
    bw.put(1, 1);
    bw.put((uint32_t)used.size() == 2 ? 1 : 0, 1);
    if (s0 < 2) {
      bw.put(0, 1);
      bw.put(s0, 1);
    } else {
      bw.put(1, 1);
      bw.put(s0, 8);
    }
    if (used.size() == 2) bw.put(used[1], 8);
    c.len.assign(freq.size(), 0);
    if (used.size() == 2) {
      c.len[used[0]] = c.len[used[1]] = 1;
      canonical_codes(c.len, c.codes);
    } else {
      c.single = 1;
    }
    return c;
  }
  if (used.size() == 1) c.single = 1;
  canonical_codes(c.len, c.codes);
  // the lengths, run-length coded with 16 (repeat the previous 3-6), 17 (3-10
  // zeros) and 18 (11-138 zeros)
  std::vector<std::pair<int, int>> tokens;  // (symbol, extra)
  const int n = (int)c.len.size();
  int i = 0, prev = 8;
  while (i < n) {
    const int v = c.len[i];
    int run = 1;
    while (i + run < n && c.len[i + run] == v) ++run;
    if (v == 0) {
      int r = run;
      while (r >= 11) {
        const int k = std::min(r, 138);
        tokens.push_back({18, k - 11});
        r -= k;
      }
      if (r >= 3) {
        tokens.push_back({17, r - 3});
        r = 0;
      }
      while (r-- > 0) tokens.push_back({0, 0});
    } else {
      int r = run;
      if (v != prev) {
        tokens.push_back({v, 0});
        --r;
        prev = v;
      }
      while (r >= 3) {
        const int k = std::min(r, 6);
        tokens.push_back({16, k - 3});
        r -= k;
      }
      while (r-- > 0) tokens.push_back({v, 0});
    }
    i += run;
  }
  std::vector<uint32_t> cl_freq(19, 0);
  for (auto& t : tokens) ++cl_freq[t.first];
  Code cl;
  code_lengths(cl_freq, 7, cl.len);
  int cl_used = 0;
  for (int k = 0; k < 19; ++k) cl_used += cl.len[k] != 0;
  if (cl_used == 1) {
    // a one-symbol code reads in 0 bits
    cl.single = 1;
  }
  canonical_codes(cl.len, cl.codes);
  int num_codes = 4;
  for (int k = 0; k < 19; ++k) if (cl.len[kCodeLengthOrder[k]]) num_codes = std::max(num_codes, k + 1);
  bw.put(0, 1);
  bw.put(num_codes - 4, 4);
  for (int k = 0; k < num_codes; ++k) bw.put(cl.len[kCodeLengthOrder[k]], 3);
  bw.put(0, 1);  // max_symbol = the alphabet size
  static const int extra[3] = {2, 3, 7};
  for (auto& t : tokens) {
    cl.put(bw, t.first);
    if (t.first >= 16) bw.put(t.second, extra[t.first - 16]);
  }
  return c;
}

inline void prefix_encode(int value, int& symbol, int& extra_bits, int& extra) {
  // value >= 1
  const int v = value - 1;
  if (v < 4) {
    symbol = v;
    extra_bits = 0;
    extra = 0;
    return;
  }
  const int highest = 31 - __builtin_clz(v);
  const int second = (v >> (highest - 1)) & 1;
  extra_bits = highest - 1;
  extra = v & ((1 << extra_bits) - 1);
  symbol = 2 * highest + second;
}

struct Token {
  uint32_t argb;  // a literal, or 0
  int length;     // 0 for a literal
  int dist_code;
};

// LZ77 with hash chains over the pixels, distances as plane codes
void backward_refs(const std::vector<uint32_t>& px, int xsize,
                   std::vector<Token>& out) {
  const int n = (int)px.size();
  out.clear();
  const int HBITS = 16, MAX_LEN = 4096, MIN_LEN = 3, DEPTH = 24;
  const int WINDOW = (1 << 20) - 120;
  std::vector<int> head(1 << HBITS, -1), chain(n, -1);
  // plane codes of the short distances of the 120-entry map
  std::vector<std::pair<int, int>> near;
  for (int c = 1; c <= 120; ++c) {
    const int dist = plane_code_to_distance(xsize, c);
    bool seen = false;
    for (auto& e : near) if (e.first == dist) seen = true;
    if (!seen) near.push_back({dist, c});
  }
  auto code_of = [&](int dist) {
    for (auto& e : near) if (e.first == dist) return e.second;
    return dist + 120;
  };
  auto hash = [&](int i) {
    const uint64_t k = ((uint64_t)px[i] << 32) | px[i + 1];
    return (uint32_t)((k * 0x9e3779b97f4a7c15ull) >> (64 - HBITS));
  };
  int i = 0;
  auto insert = [&](int j) {
    if (j + 1 < n) {
      const uint32_t h = hash(j);
      chain[j] = head[h];
      head[h] = j;
    }
  };
  while (i < n) {
    int best_len = 0, best_dist = 0;
    // the pixel above and the one to the left are always tried
    const int cands[2] = {xsize, 1};
    for (int dist : cands) {
      if (dist > i) continue;
      int l = 0;
      while (i + l < n && l < MAX_LEN && px[i + l] == px[i + l - dist]) ++l;
      if (l > best_len) {
        best_len = l;
        best_dist = dist;
      }
    }
    if (i + 1 < n && best_len < n - i) {
      int j = head[hash(i)], depth = 0;
      while (j >= 0 && depth++ < DEPTH && i - j <= WINDOW) {
        if (best_len == 0 || (i + best_len < n && px[j + best_len] == px[i + best_len])) {
          int l = 0;
          while (i + l < n && l < MAX_LEN && px[j + l] == px[i + l]) ++l;
          if (l > best_len) {
            best_len = l;
            best_dist = i - j;
          }
        }
        j = chain[j];
      }
    }
    if (best_len >= MIN_LEN) {
      out.push_back({0, best_len, code_of(best_dist)});
      for (int k = 0; k < best_len; ++k) insert(i + k);
      i += best_len;
    } else {
      out.push_back({px[i], 0, 0});
      insert(i);
      ++i;
    }
  }
}

// one image's entropy-coded part: no colour cache, one group of codes
void write_image_data(BitWriter& bw, const std::vector<uint32_t>& px, int xsize,
                      bool level0) {
  std::vector<Token> toks;
  backward_refs(px, xsize, toks);
  std::vector<uint32_t> fg(280, 0), fr(256, 0), fb(256, 0), fa(256, 0), fd(40, 0);
  for (const Token& t : toks) {
    if (t.length == 0) {
      ++fg[(t.argb >> 8) & 0xff];
      ++fr[(t.argb >> 16) & 0xff];
      ++fb[t.argb & 0xff];
      ++fa[t.argb >> 24];
    } else {
      int s, eb, e;
      prefix_encode(t.length, s, eb, e);
      ++fg[256 + s];
      prefix_encode(t.dist_code, s, eb, e);
      ++fd[s];
    }
  }
  bw.put(0, 1);  // no colour cache
  if (level0) bw.put(0, 1);  // no meta prefix codes
  const Code cg = write_code(bw, fg), cr = write_code(bw, fr),
             cb = write_code(bw, fb), ca = write_code(bw, fa),
             cd = write_code(bw, fd);
  for (const Token& t : toks) {
    if (t.length == 0) {
      cg.put(bw, (t.argb >> 8) & 0xff);
      cr.put(bw, (t.argb >> 16) & 0xff);
      cb.put(bw, t.argb & 0xff);
      ca.put(bw, t.argb >> 24);
    } else {
      int s, eb, e;
      prefix_encode(t.length, s, eb, e);
      cg.put(bw, 256 + s);
      bw.put(e, eb);
      prefix_encode(t.dist_code, s, eb, e);
      cd.put(bw, s);
      bw.put(e, eb);
    }
  }
}

inline uint32_t sub_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  const uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline int residual_cost(uint32_t r) {
  int c = 0;
  for (int k = 0; k < 32; k += 8) {
    const int v = (int8_t)((r >> k) & 0xff);
    c += std::abs(v);
  }
  return c;
}


// ------------------------------------- libwebp's rewrite under alpha 0
// cv2.imwrite(".webp") encodes through libwebp's WebPEncodeLosslessBGRA
// (quality 70, method 4, "exact" off), which does not keep the colour of a
// pixel whose alpha is 0: WebPReplaceTransparentPixels first sets every such
// pixel to 0, and when the encoder then runs the predictor transform,
// GetResidual writes the prediction's colour there (a residual of 0), row by
// row, so that later predictions read the written value. What comes back
// depends on the transforms the encoder picks (AnalyzeEntropy in
// vp8l_enc.c) and on the predictor mode it picks for each tile
// (predictor_enc.c), both on libwebp's fixed-point entropy estimates (23
// fraction bits), reproduced here in its integer arithmetic and order.

constexpr int LOG2_BITS = 23;                         // LOG_2_PRECISION_BITS
constexpr uint64_t LOG2_RECIPROCAL = 12102203;        // 2^23 / ln 2
constexpr double LOG2_RECIPROCAL_DOUBLE = 12102203.161561485;
constexpr int NUM_PRED_MODES = 14;

struct LogTables {
  uint32_t log2[256];   // round(2^23 log2(i))
  uint64_t slog2[256];  // round(2^23 log2(i) i)
  LogTables() {
    log2[0] = 0;
    slog2[0] = 0;
    for (int i = 1; i < 256; ++i) {
      const double l = std::log2((double)i);
      log2[i] = (uint32_t)std::nearbyint(8388608.0 * l);
      slog2[i] = (uint64_t)std::nearbyint(8388608.0 * l * i);
    }
  }
};

const LogTables& log_tables() {
  static const LogTables t;
  return t;
}

inline int64_t div_round(int64_t a, int64_t b) {
  return ((a < 0) == (b < 0)) ? ((a + b / 2) / b) : ((a - b / 2) / b);
}

// VP8LFastSLog2: 2^23 v log2(v)
uint64_t fast_slog2(uint32_t v) {
  const LogTables& t = log_tables();
  if (v < 256) return t.slog2[v];
  if (v < 65536) {
    const uint64_t orig = v;
    const uint64_t log_cnt = (31 - __builtin_clz(v)) - 7;
    const uint32_t y = 1u << log_cnt;
    v >>= log_cnt;
    const uint64_t correction = LOG2_RECIPROCAL * (orig & (y - 1));
    return orig * (t.log2[v] + (log_cnt << LOG2_BITS)) + correction;
  }
  return (uint64_t)(LOG2_RECIPROCAL_DOUBLE * v * std::log((double)v) + .5);
}

// VP8LBitsEntropy: the Shannon entropy of a histogram, refined by the
// least a prefix code can spend
uint64_t bits_entropy(const uint32_t* a, int n) {
  uint64_t ent = 0;
  uint32_t sum = 0, nonzeros = 0, max_val = 0;
  for (int i = 0; i < n; ++i) {
    if (a[i] != 0) {
      sum += a[i];
      ++nonzeros;
      ent += fast_slog2(a[i]);
      if (max_val < a[i]) max_val = a[i];
    }
  }
  ent = fast_slog2(sum) - ent;
  uint64_t mix;
  if (nonzeros < 5) {
    if (nonzeros <= 1) return 0;
    if (nonzeros == 2) {
      return div_round(99 * ((int64_t)sum << LOG2_BITS) + (int64_t)ent, 100);
    }
    mix = nonzeros == 3 ? 950 : 700;
  } else {
    mix = 627;
  }
  int64_t min_limit = (int64_t)(2 * (uint64_t)sum - max_val) << LOG2_BITS;
  min_limit = div_round((int64_t)mix * min_limit + (int64_t)(1000 - mix) * (int64_t)ent,
                        1000);
  return ent < (uint64_t)min_limit ? (uint64_t)min_limit : ent;
}

inline uint32_t sub_sample_size(uint32_t size, int bits) {
  return (size + (1u << bits) - 1) >> bits;
}

// libwebp's ClampBits: ``bits`` in [lo, hi], raised until the sub-sampled
// image holds at most ``limit`` entries, lowered while it stays one entry
int clamp_bits(int w, int h, int bits, int lo, int hi, uint32_t limit) {
  bits = bits < lo ? lo : bits > hi ? hi : bits;
  uint32_t size = sub_sample_size(w, bits) * sub_sample_size(h, bits);
  while (bits < hi && size > limit) {
    ++bits;
    size = sub_sample_size(w, bits) * sub_sample_size(h, bits);
  }
  while (bits > lo && size == 1) {
    size = sub_sample_size(w, bits - 1) * sub_sample_size(h, bits - 1);
    if (size != 1) break;
    --bits;
  }
  return bits;
}

enum { DIRECT = 0, SPATIAL = 1, SUB_GREEN = 2, SPATIAL_SUB_GREEN = 3, PALETTE = 4 };

inline void add_single(uint32_t p, uint32_t* a, uint32_t* r, uint32_t* g, uint32_t* b) {
  ++a[(p >> 24) & 0xff];
  ++r[(p >> 16) & 0xff];
  ++g[(p >> 8) & 0xff];
  ++b[p & 0xff];
}

inline void add_single_sub_green(uint32_t p, uint32_t* r, uint32_t* b) {
  const int green = (int)p >> 8;
  ++r[(((int)p >> 16) - green) & 0xff];
  ++b[((int)p - green) & 0xff];
}

inline uint8_t hash_pix(uint32_t pix) {
  return (uint8_t)(((((uint64_t)pix + (pix >> 19)) * 0x39c5fba7ull) & 0xffffffffu) >> 24);
}

// AnalyzeEntropy: the transform whose estimated entropy is least
int analyze_entropy(const uint32_t* argb, int w, int h, int use_palette,
                    int palette_size, int transform_bits) {
  if (use_palette && palette_size <= 16) return PALETTE;
  enum { A, AP, G, GP, R, RP, B, BP, RSG, RPSG, BSG, BPSG, PAL, TOTAL };
  std::vector<uint32_t> histo(TOTAL * 256, 0);
  auto H = [&](int k) { return histo.data() + 256 * k; };
  const uint32_t* prev_row = nullptr;
  const uint32_t* cur_row = argb;
  uint32_t pix_prev = argb[0];
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const uint32_t pix = cur_row[x];
      const uint32_t diff = sub_pixels(pix, pix_prev);
      pix_prev = pix;
      if (diff == 0 || (prev_row != nullptr && pix == prev_row[x])) continue;
      add_single(pix, H(A), H(R), H(G), H(B));
      add_single(diff, H(AP), H(RP), H(GP), H(BP));
      add_single_sub_green(pix, H(RSG), H(BSG));
      add_single_sub_green(diff, H(RPSG), H(BPSG));
      ++H(PAL)[hash_pix(pix)];
    }
    prev_row = cur_row;
    cur_row += w;
  }
  ++H(RPSG)[0];
  ++H(BPSG)[0];
  ++H(RP)[0];
  ++H(GP)[0];
  ++H(BP)[0];
  ++H(AP)[0];
  uint64_t comp[TOTAL];
  for (int j = 0; j < TOTAL; ++j) comp[j] = bits_entropy(H(j), 256);
  uint64_t ent[5];
  ent[DIRECT] = comp[A] + comp[R] + comp[G] + comp[B];
  ent[SPATIAL] = comp[AP] + comp[RP] + comp[GP] + comp[BP];
  ent[SUB_GREEN] = comp[A] + comp[RSG] + comp[G] + comp[BSG];
  ent[SPATIAL_SUB_GREEN] = comp[AP] + comp[RPSG] + comp[GP] + comp[BPSG];
  ent[PALETTE] = comp[PAL];
  const uint64_t tiles = (uint64_t)sub_sample_size(w, transform_bits) *
                         sub_sample_size(h, transform_bits);
  ent[SPATIAL] += tiles * log_tables().log2[14];            // VP8LFastLog2
  ent[SPATIAL_SUB_GREEN] += tiles * log_tables().log2[24];
  ent[PALETTE] += ((uint64_t)palette_size * 8) << LOG2_BITS;
  const int last = use_palette ? PALETTE : SPATIAL_SUB_GREEN;
  int best = DIRECT;
  for (int k = DIRECT + 1; k <= last; ++k) {
    if (ent[best] > ent[k]) best = k;
  }
  return best;
}

// GetResidual with "exact" off and no near-lossless: the residuals of
// pixels [x0, x1) of row y under ``mode``; a pixel of alpha 0 takes the
// prediction's colour (and the copy of the row's first pixel that the row
// above carries at [width] follows it)
template <int MODE>
void residual_row_mode(int width, uint32_t* upper, uint32_t* cur, int x0,
                       int x1, int y, uint32_t* out) {
  for (int x = x0; x < x1; ++x) {
    uint32_t pred;
    if (y == 0) {
      pred = x == 0 ? 0xff000000u : cur[x - 1];
    } else if (x == 0) {
      pred = upper[x];
    } else {
      pred = predict(MODE, cur[x - 1], upper + x);
    }
    uint32_t res = sub_pixels(cur[x], pred);
    if ((cur[x] & 0xff000000u) == 0) {
      res &= 0xff000000u;
      cur[x] = pred & 0x00ffffffu;
      if (x == 0 && y != 0) upper[width] = cur[0];
    }
    if (out != nullptr) out[x - x0] = res;
  }
}

void residual_row(int width, uint32_t* upper, uint32_t* cur, int mode, int x0,
                  int x1, int y, uint32_t* out) {
  using Fn = void (*)(int, uint32_t*, uint32_t*, int, int, int, uint32_t*);
  static const Fn fns[NUM_PRED_MODES] = {
      residual_row_mode<0>, residual_row_mode<1>, residual_row_mode<2>,
      residual_row_mode<3>, residual_row_mode<4>, residual_row_mode<5>,
      residual_row_mode<6>, residual_row_mode<7>, residual_row_mode<8>,
      residual_row_mode<9>, residual_row_mode<10>, residual_row_mode<11>,
      residual_row_mode<12>, residual_row_mode<13>};
  fns[mode](width, upper, cur, x0, x1, y, out);
}

// PredictionCostBias: favours residuals near 0 (weight 1, 0.94 decaying by
// 0.6 a step, in hundredths and tenths)
int64_t prediction_cost_bias(const uint32_t* counts) {
  uint64_t bits = (uint64_t)counts[0] << LOG2_BITS;
  uint64_t exp_val = 94ull << LOG2_BITS;
  for (int i = 1; i < 16; ++i) {
    bits += div_round((int64_t)(exp_val * (counts[i] + counts[256 - i])), 100);
    exp_val = div_round((int64_t)(6 * exp_val), 10);
  }
  return -div_round((int64_t)bits, 10);
}

// libwebp's VP8LCombinedShannonEntropy(X, Y), the entropy of X and of X +
// Y, against one Y (the accumulated histogram) for many X (a tile's, under
// each mode): Y's sum and sum of v log2(v) taken once, the same unsigned
// sums as libwebp's in another order
struct Accumulated {
  const uint32_t* y;
  uint32_t sum[4];
  uint64_t slog[4];
  explicit Accumulated(const uint32_t* histo) : y(histo) {
    for (int c = 0; c < 4; ++c) {
      sum[c] = 0;
      slog[c] = 0;
      for (int i = 0; i < 256; ++i) {
        sum[c] += y[256 * c + i];
        slog[c] += fast_slog2(y[256 * c + i]);
      }
    }
  }
  // VP8LCombinedShannonEntropy(X, Y's channel c)
  uint64_t combined(const uint32_t* X, int c) const {
    const uint32_t* Y = y + 256 * c;
    uint64_t ret = slog[c];
    uint32_t sum_x = 0;
    for (int i = 0; i < 256; ++i) {
      const uint32_t x = X[i];
      if (x != 0) {
        sum_x += x;
        ret += fast_slog2(x) + fast_slog2(x + Y[i]) - fast_slog2(Y[i]);
      }
    }
    return fast_slog2(sum_x) + fast_slog2(sum_x + sum[c]) - ret;
  }
};

int64_t prediction_cost(const Accumulated& accumulated, const uint32_t* tile,
                        int mode, int left_mode, int above_mode) {
  int64_t ret = 0;
  for (int i = 0; i < 4; ++i) {
    ret += prediction_cost_bias(tile + 256 * i);
    ret += (int64_t)accumulated.combined(tile + 256 * i, i);
  }
  const int64_t bias = 15ll << LOG2_BITS;   // kSpatialPredictorBias
  if (mode == left_mode) ret -= bias;
  if (mode == above_mode) ret -= bias;
  return ret;
}

// GetBestPredictorForTile, part 1: the histograms of each mode's residuals
// over tile (tx, ty), 4 x 256 a mode (the rows and columns around the tile
// read as they were before any rewrite, which the mode search never makes)
void tile_histograms(int w, int h, int tx, int ty, int bits,
                     const uint32_t* argb, uint32_t* histos) {
  const int start_x = tx << bits, start_y = ty << bits;
  const int max_y = std::min(1 << bits, h - start_y);
  const int max_x = std::min(1 << bits, w - start_x);
  const int have_left = start_x > 0;
  const int cx = start_x - have_left;
  std::vector<uint32_t> scratch(2 * (size_t)(w + 1)), res(max_x);
  uint32_t* upper = scratch.data();
  uint32_t* cur = upper + w + 1;
  std::fill(histos, histos + NUM_PRED_MODES * 1024, 0);
  for (int mode = 0; mode < NUM_PRED_MODES; ++mode) {
    uint32_t* histo = histos + mode * 1024;
    if (start_y > 0) {
      memcpy(cur + cx, argb + (size_t)(start_y - 1) * w + cx,
             sizeof(uint32_t) * (max_x + have_left + 1));
    }
    for (int ry = 0; ry < max_y; ++ry) {
      const int y = start_y + ry;
      std::swap(upper, cur);
      memcpy(cur + cx, argb + (size_t)y * w + cx,
             sizeof(uint32_t) * (max_x + have_left + (y + 1 < h)));
      residual_row(w, upper, cur, mode, start_x, start_x + max_x, y, res.data());
      for (int i = 0; i < max_x; ++i) {
        const uint32_t r = res[i];
        ++histo[r >> 24];
        ++histo[256 + ((r >> 16) & 0xff)];
        ++histo[512 + ((r >> 8) & 0xff)];
        ++histo[768 + (r & 0xff)];
      }
    }
  }
}

// part 2: the mode of least cost against the histogram accumulated over
// the tiles before it (the first of equal costs), which its histogram joins
int pick_mode(std::vector<uint32_t>& accumulated, const uint32_t* histos,
              int left_mode, int above_mode) {
  const Accumulated acc(accumulated.data());
  int64_t best_cost = INT64_MAX;
  int best_mode = 0;
  for (int mode = 0; mode < NUM_PRED_MODES; ++mode) {
    const int64_t cost = prediction_cost(acc, histos + mode * 1024, mode,
                                         left_mode, above_mode);
    if (cost < best_cost) {
      best_cost = cost;
      best_mode = mode;
    }
  }
  const uint32_t* best = histos + best_mode * 1024;
  for (int i = 0; i < 4 * 256; ++i) accumulated[i] += best[i];
  return best_mode;
}

// the number of colours of an image, 0 when there are more than 256
int count_colors(const uint32_t* argb, size_t n) {
  constexpr int SLOTS = 1024;   // open addressing, never more than 257 used
  uint32_t keys[SLOTS];
  bool used[SLOTS] = {};
  int count = 0;
  uint32_t last = 0;
  for (size_t i = 0; i < n; ++i) {
    const uint32_t c = argb[i];
    if (i > 0 && c == last) continue;
    last = c;
    uint32_t k = (c * 0x1e35a7bdu) >> 22;
    while (used[k] && keys[k] != c) k = (k + 1) & (SLOTS - 1);
    if (!used[k]) {
      if (++count > 256) return 0;
      used[k] = true;
      keys[k] = c;
    }
  }
  return count;
}

inline uint32_t subtract_green(uint32_t p) {
  const uint32_t g = (p >> 8) & 0xff;
  return (p & 0xff00ff00u) | (((p & 0x00ff00ffu) + 0x01000100u - ((g << 16) | g)) & 0x00ff00ffu);
}

inline uint32_t add_green(uint32_t p) {
  const uint32_t g = (p >> 8) & 0xff;
  return (p & 0xff00ff00u) | (((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu);
}

// the image libwebp encodes in place of ``argb`` (rewritten in place);
// returns the transforms its analysis picked
int rewrite_transparent(uint32_t* argb, int w, int h) {
  const size_t n = (size_t)w * h;
  for (size_t i = 0; i < n; ++i) {
    if ((argb[i] >> 24) == 0) argb[i] = 0;
  }
  const int palette_size = count_colors(argb, n);
  const int use_palette = palette_size > 0;
  // GetHistoBits, then GetTransformBits at method 4
  const int histo_bits = clamp_bits(w, h, (use_palette ? 9 : 7) - 4, 2, 9, 2600);
  const int transform_bits = std::min(histo_bits, 5);
  const int entropy_ix = analyze_entropy(argb, w, h, use_palette, palette_size,
                                         transform_bits);
  if (entropy_ix != SPATIAL && entropy_ix != SPATIAL_SUB_GREEN) return entropy_ix;
  const bool sub_green = entropy_ix == SPATIAL_SUB_GREEN;
  std::vector<uint32_t> px(argb, argb + n);
  if (sub_green) {
    for (uint32_t& p : px) p = subtract_green(p);
  }
  // ApplyPredictFilter's bits: at most 2^14 tiles
  const int bits = clamp_bits(w, h, transform_bits, 2, 6, 1u << 14);
  const int tw = sub_sample_size(w, bits), th = sub_sample_size(h, bits);
  std::vector<uint8_t> modes((size_t)tw * th, 0);
  std::vector<uint32_t> accumulated(4 * 256, 0);
  // a row of tiles' histograms at once (threads), then its modes in order
  std::vector<uint32_t> histos((size_t)tw * NUM_PRED_MODES * 1024);
  for (int ty = 0; ty < th; ++ty) {
#pragma omp parallel for schedule(dynamic)
    for (int tx = 0; tx < tw; ++tx) {
      tile_histograms(w, h, tx, ty, bits, px.data(),
                      histos.data() + (size_t)tx * NUM_PRED_MODES * 1024);
    }
    for (int tx = 0; tx < tw; ++tx) {
      const int left = tx > 0 ? modes[(size_t)ty * tw + tx - 1] : 0xff;
      const int above = ty > 0 ? modes[(size_t)(ty - 1) * tw + tx] : 0xff;
      modes[(size_t)ty * tw + tx] = (uint8_t)pick_mode(
          accumulated, histos.data() + (size_t)tx * NUM_PRED_MODES * 1024,
          left, above);
    }
  }
  std::vector<uint32_t> scratch(2 * (size_t)(w + 1), 0);
  // CopyImageWithPrediction: the whole image in rows, each row read as it
  // was, the row above as it was rewritten
  uint32_t* upper = scratch.data();
  uint32_t* cur = upper + w + 1;
  for (int y = 0; y < h; ++y) {
    std::swap(upper, cur);
    memcpy(cur, px.data() + (size_t)y * w, sizeof(uint32_t) * (w + (y + 1 < h)));
    for (int x = 0; x < w; x += 1 << bits) {
      const int mode = modes[(size_t)(y >> bits) * tw + (x >> bits)];
      residual_row(w, upper, cur, mode, x, std::min(w, x + (1 << bits)), y, nullptr);
    }
    uint32_t* out = argb + (size_t)y * w;
    for (int x = 0; x < w; ++x) {
      if ((out[x] >> 24) == 0) out[x] = sub_green ? add_green(cur[x]) : cur[x];
    }
  }
  return entropy_ix;
}

}  // namespace

extern "C" {

// VP8 key frame -> Y [h][w], U and V [(h + 1) / 2][(w + 1) / 2]
int64_t webp_vp8_decode(const uint8_t* data, int64_t size, int w, int h,
                        uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  Vp8 d;
  int err = parse_headers(d, data, (size_t)size);
  if (err) return err;
  if (d.width != w || d.height != h) return ERR_BITSTREAM;
  precompute_filter_strengths(d);
  const int mb_w = d.mb_w, mb_h = d.mb_h;
  std::vector<uint8_t> Y((size_t)mb_w * 16 * mb_h * 16), U((size_t)mb_w * 8 * mb_h * 8),
      V((size_t)mb_w * 8 * mb_h * 8);
  std::vector<FInfo> finfo((size_t)mb_w * mb_h);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  std::vector<uint8_t> top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
  std::vector<MB> row(mb_w);
  Work work;
  memset(&work, 0, sizeof(work));
  for (int mby = 0; mby < mb_h; ++mby) {
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mbx = 0; mbx < mb_w; ++mbx) {
      parse_intra_mode(d, row[mbx], intra_t.data() + 4 * mbx, intra_l);
    }
    if (d.br.eof) return ERR_DATA;
    BoolReader& tbr = d.parts[mby & (d.num_parts - 1)];
    uint8_t left_nz = 0, left_nz_dc = 0;
    for (int mbx = 0; mbx < mb_w; ++mbx) {
      MB& b = row[mbx];
      int skip = d.use_skip ? b.skip : 0;
      if (!skip) {
        skip = parse_residuals(d, b, top_nz[mbx], top_nz_dc[mbx], left_nz,
                               left_nz_dc, tbr);
      } else {
        left_nz = top_nz[mbx] = 0;
        if (!b.is_i4x4) left_nz_dc = top_nz_dc[mbx] = 0;
        memset(b.coeffs, 0, sizeof(b.coeffs));
      }
      if (d.filter_type > 0) {
        FInfo f = d.fstrengths[b.segment][b.is_i4x4];
        f.inner |= !skip;
        finfo[(size_t)mby * mb_w + mbx] = f;
      }
      if (tbr.eof) return ERR_DATA;
    }
    for (int mbx = 0; mbx < mb_w; ++mbx) {
      reconstruct(d, row[mbx], mbx, mby, Y.data(), U.data(), V.data(), work);
    }
  }
  if (d.filter_type > 0) {
    for (int mby = 0; mby < mb_h; ++mby) {
      for (int mbx = 0; mbx < mb_w; ++mbx) {
        filter_mb(d, finfo[(size_t)mby * mb_w + mbx], mbx, mby, Y.data(),
                  U.data(), V.data());
      }
    }
  }
  const int ys = mb_w * 16, uvs = mb_w * 8, uw = (w + 1) / 2, uh = (h + 1) / 2;
  for (int j = 0; j < h; ++j) memcpy(y_out + (size_t)j * w, Y.data() + (size_t)j * ys, w);
  for (int j = 0; j < uh; ++j) {
    memcpy(u_out + (size_t)j * uw, U.data() + (size_t)j * uvs, uw);
    memcpy(v_out + (size_t)j * uw, V.data() + (size_t)j * uvs, uw);
  }
  return 0;
}

// VP8L image stream (after the 5-byte header) -> ARGB [h][w]
int64_t webp_vp8l_decode(const uint8_t* data, int64_t size, int w, int h,
                         uint32_t* argb) {
  LBitReader br;
  br.init(data, (size_t)size);
  return vp8l_decode_stream(br, w, h, argb);
}

// ALPH chunk payload -> alpha [h][w]
int64_t webp_alpha_decode(const uint8_t* data, int64_t size, int w, int h,
                          uint8_t* alpha) {
  if (size < 1) return ERR_DATA;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) return ERR_BITSTREAM;
  const size_t n = (size_t)w * h;
  std::vector<uint8_t> raw(n);
  if (method == 0) {
    if ((size_t)(size - 1) < n) return ERR_DATA;
    memcpy(raw.data(), data + 1, n);
  } else {
    std::vector<uint32_t> argb(n);
    LBitReader br;
    br.init(data + 1, (size_t)size - 1);
    const int err = vp8l_decode_stream(br, w, h, argb.data());
    if (err) return err;
    for (size_t i = 0; i < n; ++i) raw[i] = (uint8_t)(argb[i] >> 8);
  }
  for (int y = 0; y < h; ++y) {
    unfilter_row(filter, y == 0 ? nullptr : alpha + (size_t)(y - 1) * w,
                 raw.data() + (size_t)y * w, alpha + (size_t)y * w, w);
  }
  return 0;
}

// ARGB [h][w] -> a VP8L bitstream with its 5-byte header; ``alpha_used``
// sets the header's alpha bit
int64_t webp_vp8l_encode(const uint32_t* argb, int w, int h, int alpha_used,
                         uint8_t* out, int64_t cap) {
  if (w < 1 || h < 1 || w > 16384 || h > 16384) return ERR_BITSTREAM;
  const size_t n = (size_t)w * h;
  BitWriter bw;
  bw.put(0x2f, 8);
  bw.put(w - 1, 14);
  bw.put(h - 1, 14);
  bw.put(alpha_used ? 1 : 0, 1);
  bw.put(0, 3);
  std::vector<uint32_t> px(argb, argb + n);
  // a palette of at most 256 colours: colour indexing, pixels bundled
  std::vector<uint32_t> palette(px);
  std::sort(palette.begin(), palette.end());
  palette.erase(std::unique(palette.begin(), palette.end()), palette.end());
  int xsize = w;
  if (palette.size() <= 256) {
    const int num = (int)palette.size();
    const int bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
    bw.put(1, 1);
    bw.put(3, 2);
    bw.put(num - 1, 8);
    std::vector<uint32_t> delta(num);
    for (int i = 0; i < num; ++i) delta[i] = i ? sub_pixels(palette[i], palette[i - 1]) : palette[0];
    write_image_data(bw, delta, num, false);
    const int bpp = 8 >> bits;
    xsize = sub_sample(w, bits);
    std::vector<uint32_t> packed((size_t)xsize * h, 0);
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        const uint32_t c = px[(size_t)y * w + x];
        const uint32_t idx = (uint32_t)(std::lower_bound(palette.begin(), palette.end(), c) - palette.begin());
        packed[(size_t)y * xsize + (x >> bits)] |= idx << (8 + bpp * (x & ((1 << bits) - 1)));
      }
    }
    px.swap(packed);
  } else {
    // subtract green, then the predictor transform on 16x16 tiles
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = ((p & 0x00ff00ffu) + 0x01000100u - ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
    bw.put(1, 1);
    bw.put(2, 2);
    const int tb = 4;
    const int tw = sub_sample(w, tb), th = sub_sample(h, tb);
    std::vector<uint32_t> modes((size_t)tw * th);
    std::vector<uint32_t> res(n);
    for (int ty = 0; ty < th; ++ty) {
      for (int tx = 0; tx < tw; ++tx) {
        int best = 0;
        int64_t best_cost = -1;
        for (int mode = 0; mode < 14; ++mode) {
          int64_t cost = 0;
          for (int y = ty << tb; y < std::min(h, (ty + 1) << tb); ++y) {
            if (y == 0) continue;
            const uint32_t* row = px.data() + (size_t)y * w;
            for (int x = tx << tb; x < std::min(w, (tx + 1) << tb); ++x) {
              if (x == 0) continue;
              cost += residual_cost(sub_pixels(row[x], predict(mode, row[x - 1], row + x - w)));
            }
          }
          if (best_cost < 0 || cost < best_cost) {
            best_cost = cost;
            best = mode;
          }
        }
        modes[(size_t)ty * tw + tx] = 0xff000000u | ((uint32_t)best << 8);
      }
    }
    for (int y = 0; y < h; ++y) {
      const uint32_t* row = px.data() + (size_t)y * w;
      for (int x = 0; x < w; ++x) {
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? 0xff000000u : row[x - 1];
        } else if (x == 0) {
          pred = row[x - w];
        } else {
          pred = predict((modes[(size_t)(y >> tb) * tw + (x >> tb)] >> 8) & 0xf,
                         row[x - 1], row + x - w);
        }
        res[(size_t)y * w + x] = sub_pixels(row[x], pred);
      }
    }
    bw.put(1, 1);
    bw.put(0, 2);
    bw.put(tb - 2, 3);
    write_image_data(bw, modes, tw, false);
    px.swap(res);
  }
  bw.put(0, 1);  // no more transforms
  write_image_data(bw, px, xsize, true);
  bw.finish();
  if ((int64_t)bw.buf.size() > cap) return ERR_ROOM;
  memcpy(out, bw.buf.data(), bw.buf.size());
  return (int64_t)bw.buf.size();
}

// ARGB [h][w] -> the image cv2.imwrite(".webp")'s libwebp encodes in its
// place (the colour under alpha 0 rewritten, in place); returns the
// transforms libwebp picked (0 none, 1 predictor, 2 subtract green, 3 both,
// 4 palette)
int64_t webp_transparent_rewrite(uint32_t* argb, int w, int h) {
  if (w < 1 || h < 1) return ERR_BITSTREAM;
  return rewrite_transparent(argb, w, h);
}

}  // extern "C"
