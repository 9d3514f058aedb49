// WebP pixel coding, the host half of ops/webp.py: the VP8 (lossy, RFC 6386)
// and VP8L (lossless, RFC 9649) bitstreams and the ALPH plane, plus a small
// VP8L encoder for the port's .webp output. The RIFF container is parsed in
// Python.
//
// Decoding matches what libwebp's default decode gives (the output that
// Pillow's WebP reader returns): the VP8 frame is reconstructed as the spec
// defines it (boolean decoder, token probabilities, segment and quantiser
// headers, intra predictors, inverse DCT and WHT, the normal and simple loop
// filters), then converted to RGB with "fancy" chroma upsampling (each chroma
// sample weighted 9:3:3:1 by distance) and the 14-bit fixed-point YUV->RGB of
// the WebP library. Alpha stays non-premultiplied.
//
// Exported C ABI (every function returns 0 on success, -1 for a corrupt or
// truncated stream, -2 for a form the decoder does not handle):
//   vkgr_vp8_decode(data, size, width, height, rgba)       RGB into rgba (A = 255)
//   vkgr_vp8l_decode(data, size, width, height, header, argb)
//       one VP8L image stream (header: 1 for a VP8L chunk, 0 for the headerless
//       stream of a compressed ALPH chunk) into width*height ARGB words
//   vkgr_alpha_decode(data, size, width, height, alpha)    an ALPH chunk's payload
//   vkgr_vp8l_encode(argb, width, height, header, alpha_used, out, cap, &size)
//       subtract-green + one prefix-code group, no LZ77 (size -2: cap too small)
//
// Build: g++ -O3 -shared -fPIC -std=c++17
// With -DVKGR_WEBP_FEATURES the library also exports, for the test suite,
//   vkgr_vp8l_features(data, size, width, height, &features)
//       decodes a VP8L chunk and sets the transforms read (bit t: type t), a
//       colour cache (bit 4) and meta prefix codes (bit 5)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ VP8 tables (RFC 6386)

// intra 4x4 sub-block modes, in the spec's order
enum { B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_LD_PRED, B_RD_PRED, B_VR_PRED, B_VL_PRED,
       B_HD_PRED, B_HU_PRED, NUM_BMODES };
// 16x16 and chroma modes, numbered as the sub-block mode each implies for contexts
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED };

const int8_t kBModeTree[2 * (NUM_BMODES - 1)] = {
    -B_DC_PRED, 2, -B_TM_PRED, 4, -B_VE_PRED, 6, 8, 12, -B_HE_PRED, 10, -B_RD_PRED, -B_VR_PRED,
    -B_LD_PRED, 14, -B_VL_PRED, 16, -B_HD_PRED, -B_HU_PRED};

const uint8_t kKfBModeProbs[NUM_BMODES][NUM_BMODES][NUM_BMODES - 1] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103}, {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {144, 71, 10, 38, 171, 213, 144, 34, 26}, {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85}, {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226}, {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128}, {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {104, 79, 12, 27, 217, 255, 87, 17, 7}, {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128}, {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194}, {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205}, {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171}, {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {107, 54, 32, 26, 51, 1, 81, 43, 31}, {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73}, {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124}, {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111}, {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114}, {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {100, 80, 8, 43, 154, 1, 51, 26, 71}, {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209}, {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221}, {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82}, {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1}, {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {115, 21, 2, 10, 102, 255, 166, 23, 6}, {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114}, {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43}, {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229}, {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154}, {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {57, 46, 22, 24, 128, 1, 54, 17, 37}, {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183}, {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223}, {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226}, {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213}, {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {75, 32, 12, 51, 192, 255, 160, 43, 51}, {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73}, {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192}, {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192}, {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171}, {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {75, 15, 9, 9, 64, 255, 184, 119, 16}, {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85}, {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128}, {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218}, {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128}, {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {83, 12, 13, 54, 192, 255, 68, 47, 28}, {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213}, {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246}, {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45}, {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85}, {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {146, 36, 19, 30, 171, 255, 97, 27, 20}, {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142}, {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163}, {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

const uint8_t kCoeffProbs0[4][8][3][11] = {
    {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
     {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
     {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
     {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
     {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
     {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
     {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
     {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
     {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
     {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
     {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
     {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
     {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
    {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
     {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
     {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
     {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
     {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
     {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
     {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
     {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
     {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
     {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
     {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

const uint8_t kCoeffUpdateProbs[4][8][3][11] = {
    {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,  18,  19,  20,
    20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,
    35,  36,  37,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,
    71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,
    89,  91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124,
    126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,  21,  22,
    23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,
    42,  43,  44,  45,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,
    64,  66,  68,  70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100,
    102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149,
    152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217,
    221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// ------------------------------------------------------------------ VP8 boolean decoder (RFC 6386 7.3)

struct BoolDecoder {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t range = 255;
  uint32_t value = 0;
  int bit_count = 0;
  int overrun = 0;  // bytes asked for past the end (read as zeros)

  void init(const uint8_t* start, size_t size) {
    p = start;
    end = start + size;
    value = (next() << 8) | next();
  }
  uint32_t next() {
    if (p < end) return *p++;
    ++overrun;
    return 0;
  }
  int bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint32_t big = split << 8;
    int b;
    if (value >= big) {
      b = 1;
      range -= split;
      value -= big;
    } else {
      b = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return b;
  }
  int literal(int n) {  // n-bit unsigned, most significant bit first
    int v = 0;
    while (n-- > 0) v = (v << 1) | bit(128);
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return bit(128) ? -v : v;
  }
  // a byte past the end was needed: the value holds two bytes ahead of the bits decoded
  bool eof() const { return overrun >= 2; }
};

int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------------ VP8 transforms

int mul1(int a) { return ((a * 20091) >> 16) + a; }
int mul2(int a) { return (a * 35468) >> 16; }

constexpr int BPS = 32;  // stride of the macroblock work buffer

// inverse DCT of one 4x4 block added to dst (RFC 6386 14.3)
void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass, row i
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

// inverse Walsh-Hadamard transform of the Y2 block into the DCs of the 16 luma blocks
void iwht(const int16_t* in, int16_t* out) {
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
    out[(4 * i + 0) * 16] = static_cast<int16_t>((a0 + a1) >> 3);
    out[(4 * i + 1) * 16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[(4 * i + 2) * 16] = static_cast<int16_t>((a0 - a1) >> 3);
    out[(4 * i + 3) * 16] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

// ------------------------------------------------------------------ VP8 intra predictors (RFC 6386 12)

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[y * BPS - 1];
    for (int x = 0; x < size; ++x) DST(x, y) = clip8(top[x] + l - tl);
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

// 16x16 (size 16) or chroma (size 8) prediction; mode is DC/V/H/TM
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = 0;
      if (has_top && has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[i * BPS - 1];
        dc = (dc + size) >> (shift + 1);
      } else if (has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i * BPS - 1];
        dc = (dc + (size >> 1)) >> shift;
      } else if (has_top) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        dc = (dc + (size >> 1)) >> shift;
      } else {
        dc = 0x80;
      }
      fill(dst, size, dc);
      break;
    }
    case V_PRED:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
    default:
      true_motion(dst, size);
      break;
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[BPS - 1], K = dst[2 * BPS - 1], L = dst[3 * BPS - 1];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * BPS - 1];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) memcpy(dst + y * BPS, v, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST

// ------------------------------------------------------------------ VP8 loop filter (RFC 6386 15)

inline int sclamp(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
inline int sclip1(int v) { return sclamp(v, -128, 127); }  // [-1020, 1020] -> [-128, 127]
inline int sclip2(int v) { return sclamp(v, -16, 15); }    // [-112, 112] -> [-16, 15]

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
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

inline void filter6(uint8_t* p, int step) {
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

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it && abs(q3 - q2) <= it &&
         abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// an edge of `size` pixels: hstride across the edge, vstride along it
void simple_edge(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t,
                 bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      filter2(p, hstride);
    else if (mb_edge)
      filter6(p, hstride);
    else
      filter4(p, hstride);
  }
}

// ------------------------------------------------------------------ VP8 frame decoder

struct FilterInfo {
  int limit = 0;   // 0: no filtering
  int ilevel = 0;  // interior limit
  int hev_thresh = 0;
  bool inner = false;
};

struct Vp8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDecoder br;
  std::vector<BoolDecoder> parts;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  int seg_probs[3] = {255, 255, 255};
  // filter header
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;  // 0 off, 1 simple, 2 normal
  // dequantisation factors per segment: y1 dc/ac, y2 dc/ac, uv dc/ac
  int dq[4][6];
  uint8_t probs[4][8][3][11];
  bool use_skip = false;
  int skip_prob = 0;
  FilterInfo fstrength[4][2];
  // the frame, padded to whole macroblocks
  std::vector<uint8_t> Y, U, V;
  int ystride = 0, uvstride = 0;
};

int parse_headers(Vp8Decoder& d, const uint8_t* data, size_t size) {
  if (size < 10) return -1;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (!key_frame) return -2;  // a WebP image is one key frame
  if (profile > 3 || !show) return -1;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return -1;
  const int w = (data[6] | (data[7] << 8)) & 0x3fff;
  const int h = (data[8] | (data[9] << 8)) & 0x3fff;
  if (w != d.width || h != d.height || w == 0 || h == 0) return -1;
  data += 10;
  size -= 10;
  if (part0 > size) return -1;
  d.br.init(data, part0);
  BoolDecoder& br = d.br;
  br.literal(1);  // colour space
  br.literal(1);  // clamping type
  // segment header
  d.use_segment = br.literal(1);
  if (d.use_segment) {
    d.update_map = br.literal(1);
    if (br.literal(1)) {
      d.absolute_delta = br.literal(1);
      for (int s = 0; s < 4; ++s) d.seg_quant[s] = br.literal(1) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) d.seg_filter[s] = br.literal(1) ? br.signed_literal(6) : 0;
    }
    if (d.update_map)
      for (int s = 0; s < 3; ++s) d.seg_probs[s] = br.literal(1) ? br.literal(8) : 255;
  }
  // filter header
  d.simple = br.literal(1);
  d.level = br.literal(6);
  d.sharpness = br.literal(3);
  d.use_lf_delta = br.literal(1);
  if (d.use_lf_delta && br.literal(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) d.ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) d.mode_lf_delta[i] = br.signed_literal(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof()) return -1;
  // token partitions
  const uint8_t* buf = data + part0;
  size_t left = size - part0;
  const int last = (1 << br.literal(2)) - 1;
  if (left < static_cast<size_t>(3 * last)) return -1;
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  left -= 3 * last;
  d.parts.assign(last + 1, BoolDecoder());
  for (int p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    d.parts[p].init(start, psize);
    start += psize;
    left -= psize;
    sz += 3;
  }
  if (left == 0) return -1;
  d.parts[last].init(start, left);
  // quantisers
  const int q0 = br.literal(7);
  int delta[5];
  for (int i = 0; i < 5; ++i) delta[i] = br.literal(1) ? br.signed_literal(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int q = q0;
    if (d.use_segment) {
      q = d.seg_quant[s];
      if (!d.absolute_delta) q += q0;
    }
    int* m = d.dq[s];
    m[0] = kDcTable[clip(q + delta[0], 127)];
    m[1] = kAcTable[clip(q, 127)];
    m[2] = kDcTable[clip(q + delta[1], 127)] * 2;
    m[3] = kAcTable[clip(q + delta[2], 127)] * 155 / 100;
    if (m[3] < 8) m[3] = 8;
    m[4] = kDcTable[clip(q + delta[3], 117)];
    m[5] = kAcTable[clip(q + delta[4], 127)];
  }
  br.literal(1);  // refresh_entropy_probs: one frame, nothing to keep
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          d.probs[t][b][c][p] = br.bit(kCoeffUpdateProbs[t][b][c][p]) ? br.literal(8) : kCoeffProbs0[t][b][c][p];
  d.use_skip = br.literal(1);
  if (d.use_skip) d.skip_prob = br.literal(8);
  if (br.eof()) return -1;
  // loop-filter strengths per segment and per (16x16, 4x4) prediction
  if (d.filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = d.level;
      if (d.use_segment) {
        base = d.seg_filter[s];
        if (!d.absolute_delta) base += d.level;
      }
      for (int i4 = 0; i4 <= 1; ++i4) {
        FilterInfo& f = d.fstrength[s][i4];
        int lvl = base;
        if (d.use_lf_delta) {
          lvl += d.ref_lf_delta[0];
          if (i4) lvl += d.mode_lf_delta[0];
        }
        lvl = clip(lvl, 63);
        if (lvl > 0) {
          int il = lvl;
          if (d.sharpness > 0) {
            il >>= d.sharpness > 4 ? 2 : 1;
            if (il > 9 - d.sharpness) il = 9 - d.sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = il;
          f.limit = 2 * lvl + il;
          f.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }
  return 0;
}

// the tokens of one 4x4 block (RFC 6386 13); returns the position after the last token read
int read_coeffs(BoolDecoder& br, const uint8_t (*prob)[3][11], int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = prob[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;  // end of block
    while (!br.bit(p[1])) {       // a zero
      p = prob[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const uint8_t(*next)[11] = prob[kBands[n + 1]];
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      if (!br.bit(p[3])) {
        if (!br.bit(p[4]))
          v = 2;
        else
          v = 3 + br.bit(p[5]);
      } else if (!br.bit(p[6])) {
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
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = next[2];
    }
    const int s = br.bit(128) ? -v : v;
    out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
  }
  return 16;
}

struct MbInfo {
  int segment = 0;
  bool skip = false;
  bool is_i4x4 = false;
  uint8_t imodes[16];
  int uvmode = 0;
};

int decode_frame(Vp8Decoder& d) {
  const int mb_w = d.mb_w, mb_h = d.mb_h;
  d.ystride = mb_w * 16;
  d.uvstride = mb_w * 8;
  d.Y.assign(static_cast<size_t>(d.ystride) * mb_h * 16, 0);
  d.U.assign(static_cast<size_t>(d.uvstride) * mb_h * 8, 0);
  d.V.assign(static_cast<size_t>(d.uvstride) * mb_h * 8, 0);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  uint8_t intra_l[4];
  // non-zero contexts: 4 luma, 2 u, 2 v, 1 y2 per column (top) and for the left macroblock
  std::vector<uint8_t> nz_top(9 * mb_w, 0);
  uint8_t nz_left[9];
  // unfiltered bottom rows of the row above (prediction reads unfiltered pixels)
  std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
  std::vector<FilterInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
  // work buffer (BPS stride): luma at row 1, column 8; u and v side by side below it
  uint8_t work[BPS * 17 + BPS * 9];
  uint8_t* const ydst = work + BPS + 8;
  uint8_t* const udst = work + BPS * 18 + 8;
  uint8_t* const vdst = work + BPS * 18 + 24;  // clear of the chroma left borders at -4..-1
  int16_t coeffs[384];
  MbInfo mb;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolDecoder& tok = d.parts[mb_y & (d.parts.size() - 1)];
    memset(intra_l, B_DC_PRED, sizeof(intra_l));
    memset(nz_left, 0, sizeof(nz_left));
    // left borders and the top-left sample
    for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
    } else {
      memset(ydst - BPS - 1, 127, 16 + 4 + 1);
      memset(udst - BPS - 1, 127, 8 + 1);
      memset(vdst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      // ---- modes (first partition)
      BoolDecoder& br = d.br;
      if (d.update_map)
        mb.segment = !br.bit(d.seg_probs[0]) ? br.bit(d.seg_probs[1]) : br.bit(d.seg_probs[2]) + 2;
      else
        mb.segment = 0;
      mb.skip = d.use_skip ? br.bit(d.skip_prob) : 0;
      mb.is_i4x4 = !br.bit(145);
      uint8_t* top = &intra_t[4 * mb_x];
      if (!mb.is_i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED) : (br.bit(163) ? V_PRED : DC_PRED);
        mb.imodes[0] = static_cast<uint8_t>(ymode);
        memset(top, ymode, 4);
        memset(intra_l, ymode, 4);
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kKfBModeProbs[top[x]][ymode];
            int i = 0;
            while ((i = kBModeTree[i + br.bit(prob[i >> 1])]) > 0) {
            }
            ymode = -i;
            top[x] = static_cast<uint8_t>(ymode);
            mb.imodes[4 * y + x] = static_cast<uint8_t>(ymode);
          }
          intra_l[y] = static_cast<uint8_t>(ymode);
        }
      }
      mb.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
      if (br.eof()) return -1;

      // ---- residuals (token partition)
      memset(coeffs, 0, sizeof(coeffs));
      const int* dq = d.dq[mb.segment];
      const int dq_y1[2] = {dq[0], dq[1]}, dq_y2[2] = {dq[2], dq[3]}, dq_uv[2] = {dq[4], dq[5]};
      uint8_t* tnz = &nz_top[9 * mb_x];
      bool any_nz = false;
      if (!mb.skip) {
        int first;
        const uint8_t(*ac_prob)[3][11];
        if (!mb.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = tnz[8] + nz_left[8];
          const int nz = read_coeffs(tok, d.probs[1], ctx, dq_y2, 0, dc);
          tnz[8] = nz_left[8] = nz > 0;
          if (nz > 1) {
            iwht(dc, coeffs);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) coeffs[i] = static_cast<int16_t>(dc0);
          }
          first = 1;
          ac_prob = d.probs[0];
        } else {
          first = 0;
          ac_prob = d.probs[3];
        }
        for (int y = 0; y < 4; ++y) {
          for (int x = 0; x < 4; ++x) {
            int16_t* blk = coeffs + (4 * y + x) * 16;
            const int ctx = tnz[x] + nz_left[y];
            const int nz = read_coeffs(tok, ac_prob, ctx, dq_y1, first, blk);
            tnz[x] = nz_left[y] = nz > first;
            if (nz > 1 || blk[0] != 0) any_nz = true;
          }
        }
        for (int ch = 0; ch < 2; ++ch) {
          for (int y = 0; y < 2; ++y) {
            for (int x = 0; x < 2; ++x) {
              int16_t* blk = coeffs + 256 + ch * 64 + (2 * y + x) * 16;
              const int ctx = tnz[4 + 2 * ch + x] + nz_left[4 + 2 * ch + y];
              const int nz = read_coeffs(tok, d.probs[2], ctx, dq_uv, 0, blk);
              tnz[4 + 2 * ch + x] = nz_left[4 + 2 * ch + y] = nz > 0;
              if (nz > 1 || blk[0] != 0) any_nz = true;
            }
          }
        }
        if (tok.eof()) return -1;
      } else {
        for (int i = 0; i < 8; ++i) tnz[i] = nz_left[i] = 0;
        if (!mb.is_i4x4) tnz[8] = nz_left[8] = 0;
      }
      if (d.filter_type > 0) {
        FilterInfo f = d.fstrength[mb.segment][mb.is_i4x4];
        f.inner = f.inner || any_nz;
        finfo[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
      }

      // ---- reconstruction
      if (mb_x > 0) {  // the previous macroblock's right columns become the left border
        for (int j = -1; j < 16; ++j) memcpy(ydst + j * BPS - 4, ydst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(udst + j * BPS - 4, udst + j * BPS + 4, 4);
          memcpy(vdst + j * BPS - 4, vdst + j * BPS + 4, 4);
        }
      }
      if (mb_y > 0) {
        memcpy(ydst - BPS, &top_y[16 * mb_x], 16);
        memcpy(udst - BPS, &top_u[8 * mb_x], 8);
        memcpy(vdst - BPS, &top_v[8 * mb_x], 8);
      }
      if (mb.is_i4x4) {
        uint8_t* top_right = ydst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1)
            memset(top_right, top_y[16 * mb_x + 15], 4);
          else
            memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        // the sub-blocks of the right column take the above-right macroblock's pixels
        for (int k = 1; k <= 3; ++k) memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, mb.imodes[n]);
          idct_add(coeffs + n * 16, dst);
        }
      } else {
        predict_block(ydst, 16, mb.imodes[0], mb_y > 0, mb_x > 0);
        for (int n = 0; n < 16; ++n) idct_add(coeffs + n * 16, ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      predict_block(udst, 8, mb.uvmode, mb_y > 0, mb_x > 0);
      predict_block(vdst, 8, mb.uvmode, mb_y > 0, mb_x > 0);
      for (int n = 0; n < 4; ++n) {
        idct_add(coeffs + 256 + n * 16, udst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
        idct_add(coeffs + 320 + n * 16, vdst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
      }
      memcpy(&top_y[16 * mb_x], ydst + 15 * BPS, 16);
      memcpy(&top_u[8 * mb_x], udst + 7 * BPS, 8);
      memcpy(&top_v[8 * mb_x], vdst + 7 * BPS, 8);
      for (int j = 0; j < 16; ++j)
        memcpy(&d.Y[static_cast<size_t>(mb_y * 16 + j) * d.ystride + mb_x * 16], ydst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&d.U[static_cast<size_t>(mb_y * 8 + j) * d.uvstride + mb_x * 8], udst + j * BPS, 8);
        memcpy(&d.V[static_cast<size_t>(mb_y * 8 + j) * d.uvstride + mb_x * 8], vdst + j * BPS, 8);
      }
    }
  }
  // ---- loop filter, macroblocks in raster order
  if (d.filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FilterInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
        if (f.limit == 0) continue;
        uint8_t* y = &d.Y[static_cast<size_t>(mb_y * 16) * d.ystride + mb_x * 16];
        const int ys = d.ystride;
        if (d.filter_type == 1) {
          if (mb_x > 0) simple_edge(y, 1, ys, 16, f.limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, ys, 16, f.limit);
          if (mb_y > 0) simple_edge(y, ys, 1, 16, f.limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k * ys, ys, 1, 16, f.limit);
        } else {
          const int us = d.uvstride;
          uint8_t* u = &d.U[static_cast<size_t>(mb_y * 8) * us + mb_x * 8];
          uint8_t* v = &d.V[static_cast<size_t>(mb_y * 8) * us + mb_x * 8];
          const int il = f.ilevel, hv = f.hev_thresh;
          if (mb_x > 0) {
            normal_edge(y, 1, ys, 16, f.limit + 4, il, hv, true);
            normal_edge(u, 1, us, 8, f.limit + 4, il, hv, true);
            normal_edge(v, 1, us, 8, f.limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k) normal_edge(y + 4 * k, 1, ys, 16, f.limit, il, hv, false);
            normal_edge(u + 4, 1, us, 8, f.limit, il, hv, false);
            normal_edge(v + 4, 1, us, 8, f.limit, il, hv, false);
          }
          if (mb_y > 0) {
            normal_edge(y, ys, 1, 16, f.limit + 4, il, hv, true);
            normal_edge(u, us, 1, 8, f.limit + 4, il, hv, true);
            normal_edge(v, us, 1, 8, f.limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k) normal_edge(y + 4 * k * ys, ys, 1, 16, f.limit, il, hv, false);
            normal_edge(u + 4 * us, us, 1, 8, f.limit, il, hv, false);
            normal_edge(v + 4 * us, us, 1, 8, f.limit, il, hv, false);
          }
        }
      }
    }
  }
  return 0;
}

// ------------------------------------------------------------------ YUV -> RGB

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip(int v) { return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// one output row from its luma row and two chroma rows: `near` weighs 3, `far` 1
// vertically, and across the row each chroma sample weighs 3:1 against its neighbour
void upsample_row(const uint8_t* y, const uint8_t* near_u, const uint8_t* near_v, const uint8_t* far_u,
                  const uint8_t* far_v, int len, uint8_t* dst) {
  int tl_u = near_u[0], tl_v = near_v[0], l_u = far_u[0], l_v = far_v[0];
  yuv_to_rgb(y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = near_u[x], t_v = near_v[x], u = far_u[x], v = far_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, dst + (2 * x - 1) * 4);
    yuv_to_rgb(y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, dst + (2 * x) * 4);
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1))
    yuv_to_rgb(y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst + (len - 1) * 4);
}

// ------------------------------------------------------------------ VP8L (RFC 9649)

struct BitReaderL {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;  // bit position
  bool eos = false;

  uint32_t read(int n) {  // LSB first
    uint32_t v = 0;
    for (int i = 0; i < n;) {
      const size_t byte = pos >> 3;
      const int off = static_cast<int>(pos & 7);
      const int take = (8 - off) < (n - i) ? (8 - off) : (n - i);
      uint32_t b = 0;
      if (byte < size) {
        b = (data[byte] >> off) & ((1u << take) - 1);
      } else {
        eos = true;
      }
      v |= b << i;
      i += take;
      pos += take;
    }
    return v;
  }
  uint32_t peek(int n) const {  // up to 24 bits, zeros past the end
    uint32_t v = 0;
    const size_t byte = pos >> 3;
    for (int k = 0; k < 4; ++k)
      if (byte + k < size) v |= static_cast<uint32_t>(data[byte + k]) << (8 * k);
    return (v >> (pos & 7)) & ((1u << n) - 1);
  }
  void skip(int n) {
    pos += n;
    if (pos > 8 * size) eos = true;
  }
};

constexpr int kMaxLen = 15;
constexpr int kRootBits = 8;

struct Huffman {
  // canonical code: symbols sorted by (length, symbol); a root table for short codes
  int count[kMaxLen + 1];
  std::vector<uint16_t> symbols;
  int single = -1;  // the one symbol of a zero-bit code
  std::vector<uint32_t> root;  // (length << 16) | symbol, length 0: longer than kRootBits

  bool build(const std::vector<int>& lengths) {
    memset(count, 0, sizeof(count));
    int nonzero = 0;
    for (int l : lengths) {
      if (l > kMaxLen) return false;
      ++count[l];
      if (l) ++nonzero;
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      for (size_t s = 0; s < lengths.size(); ++s)
        if (lengths[s]) single = static_cast<int>(s);
      return true;
    }
    int left = 1;  // the code must be complete
    for (int l = 1; l <= kMaxLen; ++l) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int offs[kMaxLen + 2];
    offs[1] = 0;
    for (int l = 1; l <= kMaxLen; ++l) offs[l + 1] = offs[l] + count[l];
    symbols.assign(nonzero, 0);
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) symbols[offs[lengths[s]]++] = static_cast<uint16_t>(s);
    root.assign(1u << kRootBits, 0);
    int code = 0, idx = 0;
    for (int l = 1; l <= kRootBits; ++l) {
      for (int k = 0; k < count[l]; ++k, ++code, ++idx) {
        int rev = 0;  // the code's bits come first-bit-lowest from the stream
        for (int b = 0; b < l; ++b) rev |= ((code >> (l - 1 - b)) & 1) << b;
        for (int r = rev; r < (1 << kRootBits); r += 1 << l) root[r] = (static_cast<uint32_t>(l) << 16) | symbols[idx];
      }
      code <<= 1;
    }
    return true;
  }

  int read(BitReaderL& br) const {
    if (single >= 0) return single;
    const uint32_t e = root[br.peek(kRootBits)];
    if (e >> 16) {
      br.skip(e >> 16);
      return e & 0xffff;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= kMaxLen; ++l) {
      code |= static_cast<int>(br.read(1));
      const int c = count[l];
      if (code - first < c) return symbols[index + code - first];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    br.eos = true;
    return 0;
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

bool read_huffman(BitReaderL& br, int alphabet, Huffman& h) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols
    const int n = br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    int s = br.read(first_bits);
    if (s < alphabet) lengths[s] = 1;
    if (n == 2) {
      s = br.read(8);
      if (s < alphabet) lengths[s] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int num = br.read(4) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Huffman lc;
    if (!lc.build(cl)) return false;
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) return false;
    }
    int prev = 8, sym = 0;
    while (sym < alphabet) {
      if (max_symbol-- == 0) break;
      const int c = lc.read(br);
      if (br.eos) return false;
      if (c < 16) {
        lengths[sym++] = c;
        if (c) prev = c;
      } else {
        const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        const int repeat = br.read(extra[c - 16]) + offset[c - 16];
        if (sym + repeat > alphabet) return false;
        const int l = c == 16 ? prev : 0;
        for (int k = 0; k < repeat; ++k) lengths[sym++] = l;
      }
    }
  }
  if (br.eos) return false;
  return h.build(lengths);
}

const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39,
    0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a,
    0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e,
    0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72,
    0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dc = kCodeToPlane[code - 1];
  const int yoff = dc >> 4, xoff = 8 - (dc & 0xf);
  const int dist = yoff * xsize + xoff;
  return dist >= 1 ? dist : 1;
}

int prefix_value(int sym, BitReaderL& br) {  // the LZ77 length and distance prefix codes
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

struct LosslessDecoder {
  BitReaderL br;
  int seen = 0;         // bit t: transform type t was read
  int cache_used = 0;   // some image of the stream has a colour cache
  int meta_used = 0;    // the main image has meta prefix codes
  std::vector<Transform> transforms;

  // one entropy-coded image of xsize*ysize ARGB pixels; top: the main image, whose stream may
  // carry transforms and meta prefix codes
  bool image(int xsize, int ysize, bool top, std::vector<uint32_t>& out) {
    int xs = xsize;
    if (top) {
      while (br.read(1)) {
        const int type = br.read(2);
        if (seen & (1 << type)) return false;
        seen |= 1 << type;
        Transform t{type, 0, xs, {}};
        if (type == 0 || type == 1) {  // predictor, colour
          t.bits = 2 + br.read(3);
          if (!image(subsample(xs, t.bits), subsample(ysize, t.bits), false, t.data)) return false;
        } else if (type == 3) {  // colour indexing
          const int n = br.read(8) + 1;
          t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
          std::vector<uint32_t> pal;
          if (!image(n, 1, false, pal)) return false;
          t.data.assign(1u << (8 >> t.bits), 0);
          for (int i = 0; i < n; ++i) {  // the palette is delta-coded, channel by channel
            uint32_t c = pal[i];
            if (i > 0) {
              const uint32_t p = t.data[i - 1];
              c = (((c & 0xff00ff00u) + (p & 0xff00ff00u)) & 0xff00ff00u) |
                  (((c & 0x00ff00ffu) + (p & 0x00ff00ffu)) & 0x00ff00ffu);
            }
            t.data[i] = c;
          }
          xs = subsample(xs, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      cache_used = 1;
      if (cache_bits < 1 || cache_bits > 11) return false;
    }
    int meta_bits = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (top && br.read(1)) {
      meta_bits = 2 + br.read(3);
      meta_used = 1;
      if (!image(subsample(xs, meta_bits), subsample(ysize, meta_bits), false, meta)) return false;
      for (auto& m : meta) {
        m = (m >> 8) & 0xffff;
        if (static_cast<int>(m) + 1 > groups) groups = m + 1;
      }
    }
    if (br.eos) return false;
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Huffman> codes(5 * static_cast<size_t>(groups));
    for (int g = 0; g < groups; ++g) {
      const int sizes[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
      for (int j = 0; j < 5; ++j)
        if (!read_huffman(br, sizes[j], codes[5 * g + j])) return false;
    }
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const size_t total = static_cast<size_t>(xs) * ysize;
    out.assign(total, 0);
    size_t pos = 0, cached = 0;
    const int meta_xs = meta_bits ? subsample(xs, meta_bits) : 0;
    auto insert = [&](size_t upto) {
      for (; cached < upto; ++cached) cache[(0x1e35a7bdu * out[cached]) >> (32 - cache_bits)] = out[cached];
    };
    while (pos < total) {
      const int x = static_cast<int>(pos % xs), y = static_cast<int>(pos / xs);
      const int g = meta_bits ? meta[(y >> meta_bits) * meta_xs + (x >> meta_bits)] : 0;
      const Huffman* h = &codes[5 * static_cast<size_t>(g)];
      const int green = h[0].read(br);
      if (green < 256) {
        const int red = h[1].read(br), blue = h[2].read(br), alpha = h[3].read(br);
        out[pos++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (green << 8) | blue;
      } else if (green < 256 + 24) {
        const int length = prefix_value(green - 256, br);
        const int dsym = h[4].read(br);
        const int dist = plane_to_distance(xs, prefix_value(dsym, br));
        if (br.eos) return false;
        if (static_cast<size_t>(dist) > pos || total - pos < static_cast<size_t>(length)) return false;
        for (int k = 0; k < length; ++k, ++pos) out[pos] = out[pos - dist];
      } else {
        const int key = green - 256 - 24;
        if (key >= cache_size) return false;
        insert(pos);
        out[pos++] = cache[key];
      }
      if (br.eos) return false;
      if (cache_size) insert(pos);
    }
    return true;
  }
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
    pa_minus_pb += abs(b - c) - abs(a - c);
  }
  return pa_minus_pb <= 0 ? t : l;
}

uint32_t clamp_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 8)
    r |= static_cast<uint32_t>(clip255(static_cast<int>((a >> s) & 0xff) + static_cast<int>((b >> s) & 0xff) -
                                       static_cast<int>((c >> s) & 0xff)))
         << s;
  return r;
}

uint32_t clamp_half(uint32_t avg, uint32_t c) {
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (avg >> s) & 0xff, b = (c >> s) & 0xff;
    r |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
  }
  return r;
}

uint32_t predict(int mode, const uint32_t* cur, const uint32_t* up, int x) {
  const uint32_t L = cur[x - 1], T = up[x], TR = up[x + 1], TL = up[x - 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamp_full(L, T, TL);
    case 13: return clamp_half(average2(L, T), TL);
    default: return 0xff000000u;
  }
}

// undo one transform in place; pix holds the image at the transform's input size (its xsize
// columns, or fewer for colour indexing) and comes out at xsize columns
void inverse_transform(const Transform& t, int ysize, std::vector<uint32_t>& pix) {
  const int w = t.xsize;
  if (t.type == 2) {  // subtract green
    for (auto& p : pix) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = (((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu);
      p = (p & 0xff00ff00u) | rb;
    }
  } else if (t.type == 0) {  // predictor: rows in order, each from the row above
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < ysize; ++y) {
      uint32_t* cur = &pix[static_cast<size_t>(y) * w];
      if (y == 0) {
        cur[0] = add_pixels(cur[0], 0xff000000u);
        for (int x = 1; x < w; ++x) cur[x] = add_pixels(cur[x], cur[x - 1]);
        continue;
      }
      const uint32_t* up = cur - w;
      cur[0] = add_pixels(cur[0], up[0]);
      const uint32_t* modes = &t.data[static_cast<size_t>(y >> t.bits) * tiles];
      for (int x = 1; x < w; ++x) cur[x] = add_pixels(cur[x], predict((modes[x >> t.bits] >> 8) & 0xf, cur, up, x));
    }
  } else if (t.type == 1) {  // colour transform
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < ysize; ++y) {
      for (int x = 0; x < w; ++x) {
        const uint32_t m = t.data[static_cast<size_t>(y >> t.bits) * tiles + (x >> t.bits)];
        const int8_t g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff);
        const int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
        uint32_t& p = pix[static_cast<size_t>(y) * w + x];
        const int8_t green = static_cast<int8_t>((p >> 8) & 0xff);
        int red = (p >> 16) & 0xff, blue = p & 0xff;
        red = (red + ((g2r * green) >> 5)) & 0xff;
        blue += (g2b * green) >> 5;
        blue += (r2b * static_cast<int8_t>(red)) >> 5;
        blue &= 0xff;
        p = (p & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
      }
    }
  } else {  // colour indexing, pixels bundled 2, 4 or 8 to a byte when the palette is small
    const int packed_w = subsample(w, t.bits);
    std::vector<uint32_t> out(static_cast<size_t>(w) * ysize);
    const int bits_per = 8 >> t.bits, mask = (1 << bits_per) - 1, per_byte_mask = (1 << t.bits) - 1;
    for (int y = 0; y < ysize; ++y) {
      const uint32_t* src = &pix[static_cast<size_t>(y) * packed_w];
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & per_byte_mask) == 0) packed = (*src++ >> 8) & 0xff;
        out[static_cast<size_t>(y) * w + x] = t.data[packed & mask];
        packed >>= bits_per;
      }
    }
    pix.swap(out);
  }
}

// features: null, or set to the transforms seen (bit t: type t), colour cache (bit 4), meta codes (bit 5)
int vp8l_decode(const uint8_t* data, size_t size, int width, int height, bool header, uint32_t* argb,
                int32_t* features = nullptr) {
  LosslessDecoder dec;
  dec.br.data = data;
  dec.br.size = size;
  if (header) {
    if (size < 5 || data[0] != 0x2f) return -1;
    dec.br.read(8);
    const int w = dec.br.read(14) + 1, h = dec.br.read(14) + 1;
    dec.br.read(1);  // alpha_is_used
    if (dec.br.read(3) != 0) return -1;  // version
    if (w != width || h != height) return -1;
  }
  std::vector<uint32_t> pix;
  if (!dec.image(width, height, true, pix)) return -1;
  for (size_t i = dec.transforms.size(); i-- > 0;) inverse_transform(dec.transforms[i], height, pix);
  memcpy(argb, pix.data(), pix.size() * sizeof(uint32_t));
  if (features) *features = dec.seen | (dec.cache_used << 4) | (dec.meta_used << 5);
  return 0;
}

// ------------------------------------------------------------------ VP8L encoder

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int bits) {  // LSB first
    acc |= static_cast<uint64_t>(v) << n;
    n += bits;
    while (n >= 8) {
      out.push_back(static_cast<uint8_t>(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void flush() {
    if (n > 0) out.push_back(static_cast<uint8_t>(acc));
    acc = 0;
    n = 0;
  }
};

// code lengths of at most max_len bits for the histogram (Huffman, counts flattened until
// the tree is shallow enough)
std::vector<int> code_lengths(std::vector<uint64_t> counts, int max_len) {
  const int n = static_cast<int>(counts.size());
  std::vector<int> len(n, 0);
  for (;;) {
    std::vector<int> used;
    for (int i = 0; i < n; ++i)
      if (counts[i]) used.push_back(i);
    if (used.size() < 2) {
      for (int i : used) len[i] = 1;
      return len;
    }
    // heap-free Huffman over the used symbols: two sorted queues
    std::vector<std::pair<uint64_t, int>> leaves;
    for (int i : used) leaves.push_back({counts[i], i});
    std::sort(leaves.begin(), leaves.end());
    const int m = static_cast<int>(leaves.size());
    std::vector<uint64_t> weight(2 * m);
    std::vector<int> parent(2 * m, -1);
    for (int i = 0; i < m; ++i) weight[i] = leaves[i].first;
    int lq = 0, iq = m, next = m;
    auto pick = [&]() {
      if (lq < m && (iq >= next || weight[lq] <= weight[iq])) return lq++;
      return iq++;
    };
    while (next < 2 * m - 1) {
      const int a = pick(), b = pick();
      weight[next] = weight[a] + weight[b];
      parent[a] = parent[b] = next;
      ++next;
    }
    int deepest = 0;
    std::vector<int> depth(2 * m, 0);
    for (int i = 2 * m - 3; i >= 0; --i) depth[i] = depth[parent[i]] + 1;
    for (int i = 0; i < m; ++i) {
      len[leaves[i].second] = depth[i];
      if (depth[i] > deepest) deepest = depth[i];
    }
    if (deepest <= max_len) return len;
    for (auto& c : counts)
      if (c) c = (c + 1) / 2 + 1;
    std::fill(len.begin(), len.end(), 0);
  }
}

std::vector<uint32_t> canonical_codes(const std::vector<int>& len) {  // bit-reversed for LSB-first output
  std::vector<uint32_t> codes(len.size(), 0);
  int count[kMaxLen + 2] = {0};
  for (int l : len) ++count[l];
  count[0] = 0;
  int next[kMaxLen + 2] = {0};
  int code = 0;
  for (int l = 1; l <= kMaxLen; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  for (size_t s = 0; s < len.size(); ++s) {
    const int l = len[s];
    if (!l) continue;
    const int c = next[l]++;
    uint32_t rev = 0;
    for (int b = 0; b < l; ++b) rev |= ((c >> (l - 1 - b)) & 1) << b;
    codes[s] = rev;
  }
  return codes;
}

// write one prefix code (its lengths); returns the lengths it stands for
std::vector<int> write_code(BitWriter& bw, const std::vector<uint64_t>& hist) {
  const int n = static_cast<int>(hist.size());
  std::vector<int> used;
  for (int i = 0; i < n; ++i)
    if (hist[i]) used.push_back(i);
  std::vector<int> len(n, 0);
  if (used.size() <= 2 && (used.empty() || used.back() < 256)) {  // simple code
    const int s0 = used.empty() ? 0 : used[0];
    bw.put(1, 1);
    bw.put(used.size() == 2 ? 1 : 0, 1);
    if (s0 < 2) {
      bw.put(0, 1);
      bw.put(s0, 1);
    } else {
      bw.put(1, 1);
      bw.put(s0, 8);
    }
    len[s0] = 1;
    if (used.size() == 2) {
      bw.put(used[1], 8);
      len[used[1]] = 1;
    }
    return len;
  }
  len = code_lengths(hist, kMaxLen);
  // the code-length code over the literal lengths 0..15
  std::vector<uint64_t> lh(19, 0);
  for (int l : len) ++lh[l];
  std::vector<int> ll = code_lengths(lh, 7);
  int nz = 0;
  for (int l : ll) nz += l > 0;
  if (nz == 1)  // one length for every symbol: a one-symbol code-length code reads no bits
    for (int& l : ll) l = l ? 1 : 0;
  int num = 19;
  while (num > 4 && ll[kCodeLengthOrder[num - 1]] == 0) --num;
  bw.put(0, 1);
  bw.put(num - 4, 4);
  for (int i = 0; i < num; ++i) bw.put(ll[kCodeLengthOrder[i]], 3);
  bw.put(0, 1);  // max_symbol = the alphabet size
  const std::vector<uint32_t> lc = canonical_codes(ll);
  for (int l : len)
    if (nz > 1) bw.put(lc[l], ll[l]);
  return len;
}

}  // namespace

extern "C" {

int vkgr_vp8_decode(const uint8_t* data, int64_t size, int width, int height, uint8_t* rgba) {
  Vp8Decoder d;
  d.width = width;
  d.height = height;
  d.mb_w = (width + 15) >> 4;
  d.mb_h = (height + 15) >> 4;
  int rc = parse_headers(d, data, static_cast<size_t>(size));
  if (rc) return rc;
  rc = decode_frame(d);
  if (rc) return rc;
  const uint8_t* Y = d.Y.data();
  const uint8_t* U = d.U.data();
  const uint8_t* V = d.V.data();
  const int ys = d.ystride, us = d.uvstride;
  const int last_uv_row = (height - 1) >> 1;
  for (int r = 0; r < height; ++r) {
    // row 0 and (for even heights) the last row take one chroma row; row 2k-1 leans on chroma
    // row k-1, row 2k on row k
    int near_row, far_row;
    if (r == 0) {
      near_row = far_row = 0;
    } else if (r & 1) {
      near_row = (r - 1) >> 1;
      far_row = near_row + 1 > last_uv_row ? near_row : near_row + 1;
    } else {
      near_row = r >> 1;
      far_row = near_row - 1;
    }
    upsample_row(Y + static_cast<size_t>(r) * ys, U + static_cast<size_t>(near_row) * us,
                 V + static_cast<size_t>(near_row) * us, U + static_cast<size_t>(far_row) * us,
                 V + static_cast<size_t>(far_row) * us, width, rgba + static_cast<size_t>(r) * width * 4);
  }
  for (size_t i = 0; i < static_cast<size_t>(width) * height; ++i) rgba[4 * i + 3] = 255;
  return 0;
}

int vkgr_vp8l_decode(const uint8_t* data, int64_t size, int width, int height, int header, uint32_t* argb) {
  return vp8l_decode(data, static_cast<size_t>(size), width, height, header != 0, argb);
}

#ifdef VKGR_WEBP_FEATURES
int vkgr_vp8l_features(const uint8_t* data, int64_t size, int width, int height, int32_t* features) {
  std::vector<uint32_t> argb(static_cast<size_t>(width) * height);
  return vp8l_decode(data, static_cast<size_t>(size), width, height, true, argb.data(), features);
}
#endif

int vkgr_alpha_decode(const uint8_t* data, int64_t size, int width, int height, uint8_t* alpha) {
  if (size < 1) return -1;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6) != 0) return -1;
  const size_t n = static_cast<size_t>(width) * height;
  if (method == 0) {
    if (static_cast<size_t>(size - 1) < n) return -1;
    memcpy(alpha, data + 1, n);
  } else {
    std::vector<uint32_t> argb(n);
    const int rc = vp8l_decode(data + 1, static_cast<size_t>(size - 1), width, height, false, argb.data());
    if (rc) return rc;
    for (size_t i = 0; i < n; ++i) alpha[i] = static_cast<uint8_t>(argb[i] >> 8);
  }
  if (filter == 0) return 0;
  for (int y = 0; y < height; ++y) {
    uint8_t* row = alpha + static_cast<size_t>(y) * width;
    const uint8_t* prev = y ? row - width : nullptr;
    if (filter == 1 || !prev) {  // horizontal; the first row of every filter
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < width; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {  // gradient
      int left = prev[0], top_left = prev[0];
      for (int x = 0; x < width; ++x) {
        const int top = prev[x];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
        row[x] = static_cast<uint8_t>(left);
      }
    }
  }
  return 0;
}

int vkgr_vp8l_encode(const uint32_t* argb, int width, int height, int header, int alpha_used, uint8_t* out,
                     int64_t cap, int64_t* out_size) {
  const size_t n = static_cast<size_t>(width) * height;
  std::vector<uint32_t> pix(argb, argb + n);
  for (auto& p : pix) {  // subtract green
    const uint32_t g = (p >> 8) & 0xff;
    p = (p & 0xff00ff00u) | ((((p & 0x00ff00ffu) | 0x01000100u) - ((g << 16) | g)) & 0x00ff00ffu);
  }
  BitWriter bw;
  if (header) {
    bw.put(0x2f, 8);
    bw.put(width - 1, 14);
    bw.put(height - 1, 14);
    bw.put(alpha_used ? 1 : 0, 1);
    bw.put(0, 3);
  }
  bw.put(1, 1);  // a transform: subtract green
  bw.put(2, 2);
  bw.put(0, 1);  // no more transforms
  bw.put(0, 1);  // no colour cache
  bw.put(0, 1);  // no meta prefix codes
  std::vector<uint64_t> hist[5] = {std::vector<uint64_t>(280, 0), std::vector<uint64_t>(256, 0),
                                   std::vector<uint64_t>(256, 0), std::vector<uint64_t>(256, 0),
                                   std::vector<uint64_t>(40, 0)};
  for (uint32_t p : pix) {
    ++hist[0][(p >> 8) & 0xff];
    ++hist[1][(p >> 16) & 0xff];
    ++hist[2][p & 0xff];
    ++hist[3][p >> 24];
  }
  std::vector<uint32_t> codes[4];
  std::vector<int> lens[4];
  for (int j = 0; j < 5; ++j) {
    std::vector<int> l = write_code(bw, hist[j]);
    if (j < 4) {
      lens[j] = l;
      codes[j] = canonical_codes(l);
      int nz = 0;
      for (int x : l) nz += x > 0;
      if (nz == 1)  // a one-symbol code reads no bits
        for (int& x : lens[j]) x = 0;
    }
  }
  for (uint32_t p : pix) {
    const int g = (p >> 8) & 0xff, r = (p >> 16) & 0xff, b = p & 0xff, a = p >> 24;
    bw.put(codes[0][g], lens[0][g]);
    bw.put(codes[1][r], lens[1][r]);
    bw.put(codes[2][b], lens[2][b]);
    bw.put(codes[3][a], lens[3][a]);
  }
  bw.flush();
  *out_size = static_cast<int64_t>(bw.out.size());
  if (static_cast<int64_t>(bw.out.size()) > cap) return -2;
  memcpy(out, bw.out.data(), bw.out.size());
  return 0;
}

}  // extern "C"
