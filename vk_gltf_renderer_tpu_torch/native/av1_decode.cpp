// AV1 intra decoding for the AVIF reader (ops/avif.py): the coded lossless
// subset of the AV1 specification (AV1 Bitstream & Decoding Process
// Specification, 2019), which Pillow's AVIF writer (libavif over aom)
// produces at quality 100.
//
//   * OBUs: temporal delimiter, sequence header (reduced still picture
//     header too), frame header, frame, tile group; metadata and padding
//     skipped; uniform and non-uniform tiles, each tile decoded from the
//     default CDFs with its own symbol decoder (section 8.2);
//   * a key frame that is CodedLossless: base_q_idx 0 and no DC or AC delta
//     q, so every transform block is 4x4 and inverse Walsh-Hadamard
//     (7.13.2.10), no transform type is read, and deblocking, CDEF and loop
//     restoration are off;
//   * the partition tree (every partition type), intra mode info (skip, y
//     mode from the above and left contexts, angle deltas, uv mode with CfL
//     and its alphas, filter intra), the coefficients of 4x4 blocks (all
//     zero, EOB, base, BR, DC sign, Golomb) with their contexts;
//   * intra prediction (7.11.2): DC, the directional modes with the edge
//     filter and upsampling, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, CfL and the
//     recursive filter intra; reconstruction in the spec's order, chroma of
//     sub-8x8 blocks included;
//   * 4:0:0, 4:2:0, 4:2:2 and 4:4:4 at 8 bits.
//
// Refused with kUnsupported: a frame that is not CodedLossless (lossy
// quantisation), segmentation, screen content tools (palette, IntraBC),
// more than 8 bits, superres, film grain, frames other than a shown key
// frame. Damaged data end in kBadData, never in a read past the buffer: the
// bit readers return zeros past their end (as the symbol decoder's own
// padding does) and the OBU and tile sizes are checked against the data. As
// dav1d does, a tile whose symbol decoder reads 15 or more bits past its
// data is refused.
//
// The default CDFs, smooth weights, Dr_Intra_Derivative, the filter intra
// taps and Mode_To_Angle are the specification's tables; the CDFs are kept
// as inverse CDFs (32768 minus the spec's values) with the adaptation
// counter in their last element.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr int kOk = 0, kBadData = -1, kUnsupported = -2, kNoSpace = -3;

const uint16_t kKfYModeCdf[5][5][14] = {
    {{17180, 15741, 13430, 12550, 12086, 11658, 10943, 9524, 8579, 4603, 3675, 2302, 0, 0}, {20752, 14702, 13252, 12465, 12049, 11324, 10880, 9736, 8334, 4110, 2596, 1359, 0, 0}, {22716, 21997, 10472, 9980, 9713, 9529, 8635, 7148, 6608, 3432, 2839, 1201, 0, 0}, {18677, 17362, 16326, 13960, 13632, 13222, 12770, 10672, 8022, 3183, 1810, 306, 0, 0}, {20646, 19503, 17165, 16267, 14159, 12735, 10377, 7185, 6331, 2507, 1695, 293, 0, 0}},
    {{22745, 13183, 11920, 11328, 10936, 10008, 9679, 8745, 7387, 3754, 2286, 1332, 0, 0}, {26785, 8669, 8208, 7882, 7702, 6973, 6855, 6345, 5158, 2863, 1492, 974, 0, 0}, {25324, 19987, 12591, 12040, 11691, 11161, 10598, 9363, 8299, 4853, 3678, 2276, 0, 0}, {24231, 18079, 17336, 15681, 15360, 14596, 14360, 12943, 8119, 3615, 1672, 558, 0, 0}, {25225, 18537, 17272, 16573, 14863, 12051, 10784, 8252, 6767, 3093, 1787, 774, 0, 0}},
    {{20155, 19177, 11385, 10764, 10456, 10191, 9367, 7713, 7039, 3230, 2463, 691, 0, 0}, {23081, 19298, 14262, 13538, 13164, 12621, 12073, 10706, 9549, 5025, 3557, 1861, 0, 0}, {26585, 26263, 6744, 6516, 6402, 6334, 5686, 4414, 4213, 2301, 1974, 682, 0, 0}, {22050, 21034, 17814, 15544, 15203, 14844, 14207, 11245, 8890, 3793, 2481, 516, 0, 0}, {23574, 22910, 16267, 15505, 14344, 13597, 11205, 6807, 6207, 2696, 2031, 305, 0, 0}},
    {{20166, 18369, 17280, 14387, 13990, 13453, 13044, 11349, 7708, 3072, 1851, 359, 0, 0}, {24565, 18947, 18244, 15663, 15329, 14637, 14364, 13300, 7543, 3283, 1610, 426, 0, 0}, {24317, 23037, 17764, 15125, 14756, 14343, 13698, 11230, 8163, 3650, 2690, 750, 0, 0}, {25054, 23720, 23252, 16101, 15951, 15774, 15615, 14001, 6025, 2379, 1232, 240, 0, 0}, {23925, 22488, 21272, 17451, 16116, 14825, 13660, 10050, 6999, 2815, 1785, 283, 0, 0}},
    {{20190, 19097, 16789, 15934, 13693, 11855, 9779, 7319, 6549, 2554, 1618, 291, 0, 0}, {23205, 19142, 17688, 16876, 15012, 11905, 10561, 8532, 7388, 3115, 1625, 491, 0, 0}, {24412, 23867, 15152, 14512, 13418, 12662, 10170, 6821, 6302, 2868, 2245, 507, 0, 0}, {21933, 20953, 19644, 16726, 15750, 14729, 13821, 10015, 8153, 3279, 1885, 286, 0, 0}, {25150, 24480, 22909, 22259, 17382, 14111, 9865, 3992, 3588, 1413, 966, 175, 0, 0}}};

const uint16_t kUvModeCflNotAllowedCdf[13][14] = {
    {10137, 8616, 7390, 7107, 6782, 6248, 5713, 4845, 4524, 2709, 1827, 807, 0, 0},
    {23255, 5887, 5795, 5722, 5650, 5104, 5029, 4944, 4409, 3263, 2968, 972, 0, 0},
    {22923, 22853, 4105, 4064, 4011, 3988, 3570, 2946, 2914, 2004, 991, 739, 0, 0},
    {19129, 18871, 18597, 7437, 7162, 7041, 6815, 5620, 4191, 2156, 1413, 275, 0, 0},
    {23004, 22933, 22838, 22814, 7382, 5715, 4810, 4620, 4525, 1667, 1024, 405, 0, 0},
    {20943, 19179, 19091, 19048, 17720, 3555, 3467, 3310, 3057, 1607, 1327, 218, 0, 0},
    {18593, 18369, 16160, 15947, 15050, 14993, 4217, 2568, 2523, 931, 426, 101, 0, 0},
    {19883, 19730, 17790, 17178, 17095, 17020, 16592, 3640, 3501, 2125, 807, 307, 0, 0},
    {20742, 19107, 18894, 17463, 17278, 17042, 16773, 16495, 4325, 2380, 2001, 352, 0, 0},
    {13716, 12928, 12189, 11852, 11618, 11301, 10883, 10049, 9594, 3907, 2389, 593, 0, 0},
    {14141, 13119, 11794, 11549, 11276, 10952, 10569, 9649, 9241, 5715, 1371, 620, 0, 0},
    {15742, 13764, 12771, 12429, 12182, 11665, 11419, 10861, 10286, 6872, 6227, 949, 0, 0},
    {20644, 19009, 17809, 17776, 17761, 17717, 17690, 17602, 17513, 17015, 16729, 16162, 0, 0}};

const uint16_t kUvModeCflAllowedCdf[13][15] = {
    {22361, 21560, 19868, 19587, 18945, 18593, 17869, 17112, 16782, 12682, 11773, 10313, 8556, 0, 0},
    {28236, 12988, 12711, 12553, 12340, 11697, 11569, 11317, 10669, 8540, 8075, 5736, 3296, 0, 0},
    {27495, 27389, 12591, 12498, 12383, 12329, 11819, 11073, 10994, 9630, 8512, 8065, 6089, 0, 0},
    {26028, 25601, 25106, 18616, 18232, 17983, 17734, 16027, 14397, 11248, 10562, 9379, 8586, 0, 0},
    {27781, 27400, 26840, 26700, 13654, 12453, 10911, 10515, 10357, 7857, 7388, 6741, 6392, 0, 0},
    {27398, 25879, 25521, 25375, 23270, 11654, 11366, 11015, 10787, 7988, 7382, 6251, 5592, 0, 0},
    {27952, 27807, 25564, 25442, 24003, 23838, 12599, 12086, 11965, 9580, 9005, 8313, 7828, 0, 0},
    {26160, 26028, 24239, 23719, 23511, 23412, 23033, 13941, 13709, 10432, 9564, 8804, 7975, 0, 0},
    {26770, 25349, 24987, 23835, 23513, 23219, 23015, 22351, 13870, 10274, 9629, 8004, 6779, 0, 0},
    {22108, 21470, 20218, 19811, 19446, 19144, 18728, 17764, 17234, 12054, 10979, 9325, 7907, 0, 0},
    {22246, 21238, 20216, 19805, 19390, 18989, 18523, 17533, 16866, 12666, 10072, 8994, 6930, 0, 0},
    {22669, 22077, 20129, 19719, 19382, 19103, 18643, 17605, 17132, 13092, 12294, 9249, 7560, 0, 0},
    {29624, 27681, 25386, 25264, 25175, 25078, 24967, 24704, 24536, 23520, 22893, 22247, 3720, 0, 0}};

const uint16_t kPartitionCdf[20][11] = {
    {13636, 7258, 2376, 0, 0, 0, 0, 0, 0, 0, 0},
    {18840, 12913, 4228, 0, 0, 0, 0, 0, 0, 0, 0},
    {20246, 9089, 4139, 0, 0, 0, 0, 0, 0, 0, 0},
    {22872, 13985, 6915, 0, 0, 0, 0, 0, 0, 0, 0},
    {17171, 11839, 8197, 6062, 5104, 3947, 3167, 2197, 866, 0, 0},
    {24843, 21725, 15983, 10298, 8797, 7725, 6117, 4067, 2934, 0, 0},
    {27354, 19499, 17657, 12280, 10408, 8268, 7231, 6432, 651, 0, 0},
    {30106, 26406, 24154, 11908, 9715, 7990, 6332, 4939, 1597, 0, 0},
    {14306, 11848, 9644, 5121, 4541, 3719, 3249, 2590, 1224, 0, 0},
    {25079, 23708, 20712, 7776, 7108, 6586, 5817, 4727, 3716, 0, 0},
    {26753, 23759, 22706, 8224, 7359, 6223, 5697, 5242, 721, 0, 0},
    {31374, 30560, 29972, 4154, 3707, 3302, 2928, 2583, 869, 0, 0},
    {12631, 11221, 9690, 3202, 2931, 2507, 2244, 1876, 1044, 0, 0},
    {26036, 25278, 23271, 4824, 4518, 4253, 3799, 3138, 2664, 0, 0},
    {26823, 25105, 24420, 4085, 3651, 3019, 2704, 2470, 530, 0, 0},
    {31898, 31556, 31281, 1570, 1374, 1194, 1025, 887, 436, 0, 0},
    {4869, 4549, 4239, 284, 229, 149, 129, 0, 0, 0, 0},
    {26161, 25778, 24500, 708, 549, 430, 397, 0, 0, 0, 0},
    {27339, 26092, 25646, 741, 541, 237, 186, 0, 0, 0, 0},
    {32057, 31802, 31596, 320, 230, 151, 104, 0, 0, 0, 0}};

const uint16_t kAngleDeltaCdf[8][8] = {
    {30588, 27736, 25201, 9992, 5779, 2551, 0, 0},
    {30467, 27160, 23967, 9281, 5794, 2438, 0, 0},
    {28988, 21750, 19069, 13414, 9685, 1482, 0, 0},
    {28187, 21542, 17621, 15630, 10934, 4371, 0, 0},
    {31031, 21841, 18259, 13180, 10023, 3945, 0, 0},
    {30104, 22592, 20283, 15118, 11168, 2273, 0, 0},
    {30528, 21672, 17315, 12427, 10207, 3851, 0, 0},
    {29163, 22340, 20309, 15092, 11524, 2113, 0, 0}};

const uint16_t kFilterIntraCdf[22][3] = {
    {28147, 0, 0},
    {26025, 0, 0},
    {26875, 0, 0},
    {24902, 0, 0},
    {20217, 0, 0},
    {23374, 0, 0},
    {20360, 0, 0},
    {18467, 0, 0},
    {20012, 0, 0},
    {10425, 0, 0},
    {16384, 0, 0},
    {16384, 0, 0},
    {16384, 0, 0},
    {16384, 0, 0},
    {16384, 0, 0},
    {16384, 0, 0},
    {19998, 0, 0},
    {22400, 0, 0},
    {12539, 0, 0},
    {14667, 0, 0},
    {16384, 0, 0},
    {16384, 0, 0}};

const uint16_t kFilterIntraModeCdf[1][6] = {
    {23819, 19992, 15557, 3210, 0, 0}};

const uint16_t kCflSignCdf[1][9] = {
    {31350, 30645, 19428, 14363, 5796, 4425, 474, 0, 0}};

const uint16_t kCflAlphaCdf[6][17] = {
    {25131, 12049, 1367, 287, 111, 80, 76, 72, 68, 64, 60, 56, 52, 48, 44, 0, 0},
    {18403, 9165, 4633, 1600, 601, 373, 281, 195, 148, 121, 100, 96, 92, 88, 84, 0, 0},
    {21236, 10388, 4323, 1408, 419, 245, 184, 119, 95, 91, 87, 83, 79, 75, 71, 0, 0},
    {5778, 1366, 486, 197, 76, 72, 68, 64, 60, 56, 52, 48, 44, 40, 36, 0, 0},
    {15520, 6710, 3864, 2160, 1463, 891, 642, 447, 374, 304, 252, 208, 192, 175, 146, 0, 0},
    {18030, 11090, 6989, 4867, 3744, 2466, 1788, 925, 624, 355, 248, 174, 146, 112, 108, 0, 0}};

const uint16_t kSkipCdf[3][3] = {
    {1097, 0, 0},
    {16253, 0, 0},
    {28192, 0, 0}};

const uint16_t kTxbSkipCdf[13][3] = {
    {919, 0, 0},
    {26876, 0, 0},
    {20656, 0, 0},
    {10833, 0, 0},
    {12479, 0, 0},
    {5295, 0, 0},
    {281, 0, 0},
    {25114, 0, 0},
    {13295, 0, 0},
    {2784, 0, 0},
    {22807, 0, 0},
    {2526, 0, 0},
    {651, 0, 0}};

const uint16_t kEobExtraCdf[2][9][3] = {
    {{15807, 0, 0}, {15545, 0, 0}, {25147, 0, 0}, {16384, 0, 0}, {16384, 0, 0}, {16384, 0, 0}, {16384, 0, 0}, {16384, 0, 0}, {16384, 0, 0}},
    {{13699, 0, 0}, {10243, 0, 0}, {19391, 0, 0}, {16384, 0, 0}, {16384, 0, 0}, {16384, 0, 0}, {16384, 0, 0}, {16384, 0, 0}, {16384, 0, 0}}};

const uint16_t kDcSignCdf[2][3][3] = {
    {{16768, 0, 0}, {19712, 0, 0}, {13952, 0, 0}},
    {{17536, 0, 0}, {19840, 0, 0}, {15488, 0, 0}}};

const uint16_t kEobPt16Cdf[2][2][6] = {
    {{31928, 31729, 30788, 27873, 0, 0}, {32398, 32097, 30885, 28297, 0, 0}},
    {{29521, 27818, 23080, 18205, 0, 0}, {30864, 29414, 25005, 18121, 0, 0}}};

const uint16_t kCoeffBaseEobCdf[2][4][4] = {
    {{14931, 3713, 0, 0}, {3168, 1322, 0, 0}, {1924, 890, 0, 0}, {7842, 3820, 0, 0}},
    {{11403, 2742, 0, 0}, {2256, 345, 0, 0}, {1110, 147, 0, 0}, {3138, 887, 0, 0}}};

const uint16_t kCoeffBaseCdf[2][42][5] = {
    {{28734, 23838, 20041, 0, 0}, {14686, 3027, 891, 0, 0}, {20172, 6644, 2275, 0, 0}, {23322, 11650, 5763, 0, 0}, {26460, 17627, 11489, 0, 0}, {30305, 26411, 22985, 0, 0}, {12101, 2222, 839, 0, 0}, {19725, 6645, 2634, 0, 0}, {24617, 14011, 7990, 0, 0}, {27513, 19929, 14136, 0, 0}, {29948, 25562, 21607, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {17032, 5215, 2164, 0, 0}, {21558, 8974, 3981, 0, 0}, {26821, 18894, 13067, 0, 0}, {28553, 23445, 18877, 0, 0}, {29935, 26306, 22709, 0, 0}, {13163, 2375, 1186, 0, 0}, {19245, 6516, 2520, 0, 0}, {24322, 14146, 8256, 0, 0}, {28950, 22425, 16794, 0, 0}, {31287, 28651, 25972, 0, 0}, {10119, 1466, 578, 0, 0}, {17939, 5641, 2319, 0, 0}, {24455, 15066, 9464, 0, 0}, {29746, 24467, 19982, 0, 0}, {31232, 28356, 25584, 0, 0}, {10414, 2994, 1396, 0, 0}, {18045, 7296, 3554, 0, 0}, {26095, 19023, 14106, 0, 0}, {30700, 27002, 23446, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}},
    {{26466, 16324, 11007, 0, 0}, {9728, 1230, 293, 0, 0}, {17572, 4316, 1272, 0, 0}, {22748, 9822, 4254, 0, 0}, {26235, 15906, 9267, 0, 0}, {29230, 22952, 17692, 0, 0}, {8324, 893, 243, 0, 0}, {16887, 3844, 1133, 0, 0}, {22846, 9895, 4302, 0, 0}, {26241, 15802, 9077, 0, 0}, {28654, 21465, 15548, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}, {12567, 1998, 559, 0, 0}, {18014, 4697, 1510, 0, 0}, {24390, 12582, 6251, 0, 0}, {26852, 17469, 10790, 0, 0}, {28500, 21185, 14867, 0, 0}, {8407, 743, 187, 0, 0}, {14095, 2663, 825, 0, 0}, {22572, 10524, 5192, 0, 0}, {27273, 18419, 12351, 0, 0}, {30092, 25353, 21270, 0, 0}, {8090, 810, 183, 0, 0}, {14139, 2862, 937, 0, 0}, {23404, 12044, 6453, 0, 0}, {28127, 20450, 14674, 0, 0}, {30010, 25381, 21189, 0, 0}, {7335, 926, 299, 0, 0}, {13973, 3479, 1357, 0, 0}, {25124, 15184, 9176, 0, 0}, {29360, 23754, 17721, 0, 0}, {24576, 16384, 8192, 0, 0}, {24576, 16384, 8192, 0, 0}}};

const uint16_t kCoeffBrCdf[2][21][5] = {
    {{18470, 12050, 8594, 0, 0}, {20232, 13167, 8979, 0, 0}, {24056, 17717, 13265, 0, 0}, {26598, 21441, 17334, 0, 0}, {28026, 23842, 20230, 0, 0}, {28965, 25451, 22222, 0, 0}, {31072, 29451, 27897, 0, 0}, {18376, 12817, 10012, 0, 0}, {16790, 9550, 5950, 0, 0}, {20581, 13294, 8879, 0, 0}, {23592, 17128, 12509, 0, 0}, {25700, 20113, 15740, 0, 0}, {27112, 22326, 18296, 0, 0}, {30188, 27776, 25524, 0, 0}, {20632, 14719, 11342, 0, 0}, {18984, 12047, 8287, 0, 0}, {21932, 15147, 10868, 0, 0}, {24396, 18324, 13921, 0, 0}, {26245, 20989, 16768, 0, 0}, {27431, 22870, 19008, 0, 0}, {29734, 26908, 24306, 0, 0}},
    {{16801, 9863, 6482, 0, 0}, {19234, 12114, 8189, 0, 0}, {23264, 16676, 12233, 0, 0}, {25793, 20200, 15865, 0, 0}, {27404, 22677, 18748, 0, 0}, {28411, 24398, 20911, 0, 0}, {30262, 27834, 25550, 0, 0}, {9736, 3953, 1832, 0, 0}, {13228, 6064, 3049, 0, 0}, {17610, 9799, 5671, 0, 0}, {21360, 13903, 9118, 0, 0}, {23883, 17320, 12518, 0, 0}, {25660, 19915, 15352, 0, 0}, {28537, 24727, 21288, 0, 0}, {12945, 6278, 3612, 0, 0}, {13878, 6839, 3836, 0, 0}, {17108, 9277, 5335, 0, 0}, {20621, 12992, 8280, 0, 0}, {23040, 15994, 11119, 0, 0}, {24849, 18491, 13702, 0, 0}, {27328, 22598, 18583, 0, 0}}};

const int8_t kFilterIntraTaps[5][8][7] = {
    {{-6, 10, 0, 0, 0, 12, 0}, {-5, 2, 10, 0, 0, 9, 0}, {-3, 1, 1, 10, 0, 7, 0}, {-3, 1, 1, 2, 10, 5, 0}, {-4, 6, 0, 0, 0, 2, 12}, {-3, 2, 6, 0, 0, 2, 9}, {-3, 2, 2, 6, 0, 2, 7}, {-3, 1, 2, 2, 6, 3, 5}},
    {{-10, 16, 0, 0, 0, 10, 0}, {-6, 0, 16, 0, 0, 6, 0}, {-4, 0, 0, 16, 0, 4, 0}, {-2, 0, 0, 0, 16, 2, 0}, {-10, 16, 0, 0, 0, 0, 10}, {-6, 0, 16, 0, 0, 0, 6}, {-4, 0, 0, 16, 0, 0, 4}, {-2, 0, 0, 0, 16, 0, 2}},
    {{-8, 8, 0, 0, 0, 16, 0}, {-8, 0, 8, 0, 0, 16, 0}, {-8, 0, 0, 8, 0, 16, 0}, {-8, 0, 0, 0, 8, 16, 0}, {-4, 4, 0, 0, 0, 0, 16}, {-4, 0, 4, 0, 0, 0, 16}, {-4, 0, 0, 4, 0, 0, 16}, {-4, 0, 0, 0, 4, 0, 16}},
    {{-2, 8, 0, 0, 0, 10, 0}, {-1, 3, 8, 0, 0, 6, 0}, {-1, 2, 3, 8, 0, 4, 0}, {0, 1, 2, 3, 8, 2, 0}, {-1, 4, 0, 0, 0, 3, 10}, {-1, 3, 4, 0, 0, 4, 6}, {-1, 2, 3, 4, 0, 4, 4}, {-1, 2, 2, 3, 4, 3, 3}},
    {{-12, 14, 0, 0, 0, 14, 0}, {-10, 0, 14, 0, 0, 12, 0}, {-9, 0, 0, 14, 0, 11, 0}, {-8, 0, 0, 0, 14, 10, 0}, {-10, 12, 0, 0, 0, 0, 14}, {-9, 1, 12, 0, 0, 0, 12}, {-8, 0, 0, 12, 0, 1, 11}, {-7, 0, 0, 1, 12, 1, 9}}};

// Block sizes (the spec's BLOCK_* order) in 4x4 units
enum { B4x4, B4x8, B8x4, B8x8, B8x16, B16x8, B16x16, B16x32, B32x16, B32x32, B32x64, B64x32, B64x64, B64x128,
       B128x64, B128x128, B4x16, B16x4, B8x32, B32x8, B16x64, B64x16, kBlockSizes, kBlockInvalid = 255 };
const uint8_t kW4[kBlockSizes] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const uint8_t kH4[kBlockSizes] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
enum { PNone, PHorz, PVert, PSplit, PHorzA, PHorzB, PVertA, PVertB, PHorz4, PVert4 };
// prediction modes
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED, SMOOTH_PRED,
       SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
const uint8_t kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int kModeToAngle[9] = {0, 90, 180, 45, 135, 113, 157, 203, 67};
const int kDrIntraDerivative[90] = {
    0, 0, 0, 1023, 0, 0, 547, 0, 0, 372, 0, 0, 0, 0, 273, 0, 0, 215, 0, 0, 178, 0, 0, 151, 0, 0, 132, 0, 0, 116,
    0, 0, 102, 0, 0, 0, 90, 0, 0, 80, 0, 0, 71, 0, 0, 64, 0, 0, 57, 0, 0, 51, 0, 0, 45, 0, 0, 0, 40, 0,
    0, 35, 0, 0, 31, 0, 0, 27, 0, 0, 23, 0, 0, 19, 0, 0, 15, 0, 0, 0, 0, 11, 0, 0, 7, 0, 0, 3, 0, 0};
const int kSmWeights4[4] = {255, 149, 85, 64};
const int kIntraEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
const uint8_t kDefaultScan4x4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCoeffBaseCtxOffset4x4[5][5] = {
    {0, 1, 6, 6, 0}, {1, 6, 6, 21, 0}, {6, 6, 21, 21, 0}, {6, 21, 21, 21, 0}, {0, 0, 0, 0, 0}};

int block_of(int w4, int h4) {
  for (int b = 0; b < kBlockSizes; ++b)
    if (kW4[b] == w4 && kH4[b] == h4) return b;
  return kBlockInvalid;
}

// Partition_Subsize for a square block
int subsize(int partition, int bsize) {
  const int s = kW4[bsize];
  switch (partition) {
    case PNone: return bsize;
    case PHorz: case PHorzA: case PHorzB: return block_of(s, s / 2);
    case PVert: case PVertA: case PVertB: return block_of(s / 2, s);
    case PSplit: return block_of(s / 2, s / 2);
    case PHorz4: return block_of(s, s / 4);
    default: return block_of(s / 4, s);
  }
}

// get_plane_residual_size: Subsampled_Size (BLOCK_INVALID for a tall block at 4:2:2, a wide one at 4:4:0)
int plane_size(int bsize, int ssx, int ssy) {
  const int w4 = kW4[bsize], h4 = kH4[bsize];
  if ((ssx && !ssy && h4 > w4) || (ssy && !ssx && w4 > h4)) return kBlockInvalid;
  return block_of(std::max(1, w4 >> ssx), std::max(1, h4 >> ssy));
}

int floor_log2(uint32_t x) {
  int s = 0;
  while (x > 1) {
    x >>= 1;
    ++s;
  }
  return s;
}

// f(n), leb128(), uvlc(), su(), ns() of the spec over a byte range; zeros past its end
struct BitReader {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;  // in bits
  bool over = false;
  uint32_t f(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      int b = 0;
      if (pos < n * 8)
        b = (p[pos >> 3] >> (7 - (pos & 7))) & 1;
      else
        over = true;
      ++pos;
      v = (v << 1) | uint32_t(b);
    }
    return v;
  }
  uint64_t leb128() {
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) {
      const uint32_t b = f(8);
      v |= uint64_t(b & 0x7f) << (i * 7);
      if (!(b & 0x80)) break;
    }
    return v;
  }
  uint32_t uvlc() {
    int lz = 0;
    while (!f(1)) {
      if (++lz >= 32 || over) {
        over = true;
        return 0;
      }
    }
    return f(lz) + ((1u << lz) - 1);
  }
  int su(int bits) {
    int v = int(f(bits));
    const int sign = 1 << (bits - 1);
    return (v & sign) ? v - 2 * sign : v;
  }
  uint32_t ns(uint32_t n1) {
    const int w = floor_log2(n1) + 1;
    const uint32_t m = (1u << w) - n1;
    const uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  void byte_align() { pos = (pos + 7) & ~int64_t(7); }
};

// The symbol decoder of section 8.2 over one tile's bytes
struct SymbolDecoder {
  const uint8_t* p = nullptr;
  int64_t bitpos = 0, bitend = 0, maxbits = 0;
  uint32_t rng = 0, val = 0;
  bool adapt = true;
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++bitpos)
      v = (v << 1) | (bitpos < bitend ? (p[bitpos >> 3] >> (7 - (bitpos & 7))) & 1 : 0);
    return v;
  }
  void init(const uint8_t* data, int64_t sz, bool disable_cdf_update) {
    p = data;
    bitpos = 0;
    bitend = sz * 8;
    const int nb = int(std::min<int64_t>(sz * 8, 15));
    const uint32_t buf = bits(nb);
    val = ((1u << 15) - 1) ^ (buf << (15 - nb));
    rng = 1u << 15;
    maxbits = 8 * sz - 15;
    adapt = !disable_cdf_update;
  }
  void renormalize() {
    const int b = 15 - floor_log2(rng);
    rng <<= b;
    const int nb = int(std::min<int64_t>(b, std::max<int64_t>(0, maxbits)));
    const uint32_t data = bits(nb) << (b - nb);
    val = data ^ (((val + 1) << b) - 1);
    maxbits -= b;
  }
  int decode(const uint16_t* icdf, int N) {
    uint32_t cur = rng, prev;
    int s = -1;
    do {
      ++s;
      prev = cur;
      cur = ((rng >> 8) * (uint32_t(icdf[s]) >> 6) >> 1) + 4 * uint32_t(N - s - 1);
    } while (val < cur);
    rng = prev - cur;
    val -= cur;
    renormalize();
    return s;
  }
  int symbol(uint16_t* cdf, int N) {
    const int s = decode(cdf, N);
    if (adapt) {
      const int rate = 3 + (cdf[N] > 15) + (cdf[N] > 31) + std::min(floor_log2(uint32_t(N)), 2);
      uint32_t tmp = 32768;
      for (int i = 0; i < N - 1; ++i) {
        if (i == s) tmp = 0;
        if (tmp < cdf[i])
          cdf[i] -= uint16_t((cdf[i] - tmp) >> rate);
        else
          cdf[i] += uint16_t((tmp - cdf[i]) >> rate);
      }
      cdf[N] += cdf[N] < 32;
    }
    return s;
  }
  int boolean() {
    static const uint16_t half[3] = {16384, 0, 0};
    return decode(half, 2);
  }
  uint32_t literal(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; ++i) x = 2 * x + uint32_t(boolean());
    return x;
  }
};

// The CDFs one tile adapts, copied from the defaults at its start
struct Cdfs {
  uint16_t kf_y[5][5][14], uv_no_cfl[13][14], uv_cfl[13][15], partition[20][11], angle[8][8], fi[22][3],
      fi_mode[1][6], cfl_sign[1][9], cfl_alpha[6][17], skip[3][3], txb_skip[13][3], eob_extra[2][9][3],
      dc_sign[2][3][3], eob16[2][2][6], base_eob[2][4][4], base[2][42][5], br[2][21][5];
  Cdfs() {
    std::memcpy(kf_y, kKfYModeCdf, sizeof kf_y);
    for (int i = 0; i < 13; ++i) std::memcpy(uv_no_cfl[i], kUvModeCflNotAllowedCdf[i], sizeof uv_no_cfl[i]);
    std::memcpy(uv_cfl, kUvModeCflAllowedCdf, sizeof uv_cfl);
    std::memcpy(partition, kPartitionCdf, sizeof partition);
    std::memcpy(angle, kAngleDeltaCdf, sizeof angle);
    std::memcpy(fi, kFilterIntraCdf, sizeof fi);
    std::memcpy(fi_mode, kFilterIntraModeCdf, sizeof fi_mode);
    std::memcpy(cfl_sign, kCflSignCdf, sizeof cfl_sign);
    std::memcpy(cfl_alpha, kCflAlphaCdf, sizeof cfl_alpha);
    std::memcpy(skip, kSkipCdf, sizeof skip);
    std::memcpy(txb_skip, kTxbSkipCdf, sizeof txb_skip);
    std::memcpy(eob_extra, kEobExtraCdf, sizeof eob_extra);
    std::memcpy(dc_sign, kDcSignCdf, sizeof dc_sign);
    std::memcpy(eob16, kEobPt16Cdf, sizeof eob16);
    std::memcpy(base_eob, kCoeffBaseEobCdf, sizeof base_eob);
    std::memcpy(base, kCoeffBaseCdf, sizeof base);
    std::memcpy(br, kCoeffBrCdf, sizeof br);
  }
};

struct SequenceHeader {
  bool seen = false;
  int profile = 0, still = 0, reduced = 0;
  int timing_info_present = 0, decoder_model_info_present = 0, equal_picture_interval = 0;
  int buffer_removal_time_length = 0, frame_presentation_time_length = 0;
  int op_count = 1, op_idc[32] = {0}, decoder_model_present[32] = {0};
  int frame_width_bits = 0, frame_height_bits = 0, max_w = 0, max_h = 0;
  int frame_id_numbers_present = 0, delta_frame_id_length = 0, additional_frame_id_length = 0;
  int use_128 = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
  int enable_order_hint = 0, order_hint_bits = 0, force_screen_content_tools = 2, force_integer_mv = 2;
  int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
  int bit_depth = 8, mono = 0, color_description_present = 0, cp = 2, tc = 2, mc = 2, color_range = 0;
  int ssx = 1, ssy = 1, csp = 0, separate_uv_delta_q = 0, film_grain_present = 0;
};

struct FrameHeader {
  int w = 0, h = 0, mi_cols = 0, mi_rows = 0;
  int disable_cdf_update = 0, screen_content = 0, base_q_idx = 0, coded_lossless = 0, segmentation = 0;
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0, tile_size_bytes = 4;
  int superres = 0, apply_grain = 0, show_existing = 0, frame_type = 0;
  std::vector<int> mi_col_starts, mi_row_starts;
};

int parse_sequence_header(BitReader& br, SequenceHeader& sh) {
  sh = SequenceHeader();
  sh.profile = int(br.f(3));
  sh.still = int(br.f(1));
  sh.reduced = int(br.f(1));
  if (sh.profile > 2 || (sh.reduced && !sh.still)) return kBadData;
  if (sh.reduced) {
    br.f(5);  // seq_level_idx[0]
  } else {
    sh.timing_info_present = int(br.f(1));
    if (sh.timing_info_present) {
      br.f(32);
      br.f(32);
      sh.equal_picture_interval = int(br.f(1));
      if (sh.equal_picture_interval) br.uvlc();
      sh.decoder_model_info_present = int(br.f(1));
      if (sh.decoder_model_info_present) {
        const int buffer_delay_length = int(br.f(5)) + 1;
        br.f(32);
        sh.buffer_removal_time_length = int(br.f(5)) + 1;
        sh.frame_presentation_time_length = int(br.f(5)) + 1;
        sh.op_count = 0;  // set below; the delay length is needed there
        sh.op_idc[31] = buffer_delay_length;
      }
    }
    const int initial_display_delay_present = int(br.f(1));
    const int buffer_delay_length = sh.op_idc[31];
    sh.op_count = int(br.f(5)) + 1;
    for (int i = 0; i < sh.op_count; ++i) {
      sh.op_idc[i] = int(br.f(12));
      const int level = int(br.f(5));
      if (level > 7) br.f(1);
      if (sh.decoder_model_info_present) {
        sh.decoder_model_present[i] = int(br.f(1));
        if (sh.decoder_model_present[i]) {
          br.f(buffer_delay_length);
          br.f(buffer_delay_length);
          br.f(1);
        }
      }
      if (initial_display_delay_present && br.f(1)) br.f(4);
    }
    if (!sh.decoder_model_info_present) sh.op_idc[31] = 0;
  }
  sh.frame_width_bits = int(br.f(4)) + 1;
  sh.frame_height_bits = int(br.f(4)) + 1;
  sh.max_w = int(br.f(sh.frame_width_bits)) + 1;
  sh.max_h = int(br.f(sh.frame_height_bits)) + 1;
  if (!sh.reduced) sh.frame_id_numbers_present = int(br.f(1));
  if (sh.frame_id_numbers_present) {
    sh.delta_frame_id_length = int(br.f(4)) + 2;
    sh.additional_frame_id_length = int(br.f(3)) + 1;
  }
  sh.use_128 = int(br.f(1));
  sh.enable_filter_intra = int(br.f(1));
  sh.enable_intra_edge_filter = int(br.f(1));
  if (!sh.reduced) {
    br.f(4);  // interintra compound, masked compound, warped motion, dual filter
    sh.enable_order_hint = int(br.f(1));
    if (sh.enable_order_hint) br.f(2);  // jnt_comp, ref_frame_mvs
    if (br.f(1))  // seq_choose_screen_content_tools
      sh.force_screen_content_tools = 2;
    else
      sh.force_screen_content_tools = int(br.f(1));
    if (sh.force_screen_content_tools > 0) {
      if (br.f(1))  // seq_choose_integer_mv
        sh.force_integer_mv = 2;
      else
        sh.force_integer_mv = int(br.f(1));
    } else {
      sh.force_integer_mv = 2;
    }
    if (sh.enable_order_hint) sh.order_hint_bits = int(br.f(3)) + 1;
  }
  sh.enable_superres = int(br.f(1));
  sh.enable_cdef = int(br.f(1));
  sh.enable_restoration = int(br.f(1));
  // color_config()
  const int high_bitdepth = int(br.f(1));
  if (sh.profile == 2 && high_bitdepth)
    sh.bit_depth = br.f(1) ? 12 : 10;
  else
    sh.bit_depth = high_bitdepth ? 10 : 8;
  sh.mono = sh.profile == 1 ? 0 : int(br.f(1));
  sh.color_description_present = int(br.f(1));
  if (sh.color_description_present) {
    sh.cp = int(br.f(8));
    sh.tc = int(br.f(8));
    sh.mc = int(br.f(8));
  }
  if (sh.mono) {
    sh.color_range = int(br.f(1));
    sh.ssx = sh.ssy = 1;
  } else if (sh.cp == 1 && sh.tc == 13 && sh.mc == 0) {
    sh.color_range = 1;
    sh.ssx = sh.ssy = 0;
  } else {
    sh.color_range = int(br.f(1));
    if (sh.profile == 0) {
      sh.ssx = sh.ssy = 1;
    } else if (sh.profile == 1) {
      sh.ssx = sh.ssy = 0;
    } else if (sh.bit_depth == 12) {
      sh.ssx = int(br.f(1));
      sh.ssy = sh.ssx ? int(br.f(1)) : 0;
    } else {
      sh.ssx = 1;
      sh.ssy = 0;
    }
    if (sh.ssx && sh.ssy) sh.csp = int(br.f(2));
  }
  if (!sh.mono) sh.separate_uv_delta_q = int(br.f(1));
  sh.film_grain_present = int(br.f(1));
  if (br.over) return kBadData;
  sh.seen = true;
  return kOk;
}

int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) ++k;
  return k;
}

int read_delta_q(BitReader& br) { return br.f(1) ? br.su(7) : 0; }

// uncompressed_header() of a shown key frame; everything the coded lossless subset needs
int parse_frame_header(BitReader& br, const SequenceHeader& sh, FrameHeader& fh, int temporal_id, int spatial_id) {
  fh = FrameHeader();
  int show_frame = 1, showable_frame = 0, error_resilient = 1;
  if (!sh.reduced) {
    fh.show_existing = int(br.f(1));
    if (fh.show_existing) return kUnsupported;
    fh.frame_type = int(br.f(2));
    show_frame = int(br.f(1));
    if (show_frame && sh.decoder_model_info_present && !sh.equal_picture_interval)
      br.f(sh.frame_presentation_time_length);
    showable_frame = show_frame ? fh.frame_type != 0 : int(br.f(1));
    error_resilient = (fh.frame_type == 3 || (fh.frame_type == 0 && show_frame)) ? 1 : int(br.f(1));
  }
  if (fh.frame_type != 0) return kUnsupported;  // only key frames
  fh.disable_cdf_update = int(br.f(1));
  fh.screen_content = sh.force_screen_content_tools == 2 ? int(br.f(1)) : sh.force_screen_content_tools;
  if (fh.screen_content && sh.force_integer_mv == 2) br.f(1);
  if (sh.frame_id_numbers_present) br.f(sh.delta_frame_id_length + sh.additional_frame_id_length);
  const int frame_size_override = sh.reduced ? 0 : int(br.f(1));
  br.f(sh.order_hint_bits);
  if (sh.decoder_model_info_present) {
    if (br.f(1)) {  // buffer_removal_time_present_flag
      for (int op = 0; op < sh.op_count; ++op)
        if (sh.decoder_model_present[op]) {
          const int idc = sh.op_idc[op];
          if (idc == 0 || (((idc >> temporal_id) & 1) && ((idc >> (spatial_id + 8)) & 1)))
            br.f(sh.buffer_removal_time_length);
        }
    }
  }
  if (!show_frame) {
    const int refresh = int(br.f(8));
    if (refresh != 0xFF && error_resilient && sh.enable_order_hint)
      for (int i = 0; i < 8; ++i) br.f(sh.order_hint_bits);
  }
  (void)showable_frame;
  if (frame_size_override) {
    fh.w = int(br.f(sh.frame_width_bits)) + 1;
    fh.h = int(br.f(sh.frame_height_bits)) + 1;
  } else {
    fh.w = sh.max_w;
    fh.h = sh.max_h;
  }
  if (sh.enable_superres) fh.superres = int(br.f(1));
  if (fh.superres) return kUnsupported;
  fh.mi_cols = 2 * ((fh.w + 7) >> 3);
  fh.mi_rows = 2 * ((fh.h + 7) >> 3);
  if (br.f(1)) br.f(32);  // render_and_frame_size_different: render_width_minus_1, render_height_minus_1
  if (fh.screen_content) return kUnsupported;  // palette and IntraBC are not ported
  if (!sh.reduced && !fh.disable_cdf_update) br.f(1);  // disable_frame_end_update_cdf
  // tile_info()
  const int sb_cols = sh.use_128 ? (fh.mi_cols + 31) >> 5 : (fh.mi_cols + 15) >> 4;
  const int sb_rows = sh.use_128 ? (fh.mi_rows + 31) >> 5 : (fh.mi_rows + 15) >> 4;
  const int sb_shift = sh.use_128 ? 5 : 4, sb_size = sb_shift + 2;
  const int max_tile_width_sb = 4096 >> sb_size;
  int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
  const int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
  const int max_log2_tile_cols = tile_log2(1, std::min(sb_cols, 64));
  const int max_log2_tile_rows = tile_log2(1, std::min(sb_rows, 64));
  const int min_log2_tiles = std::max(min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
  if (br.f(1)) {  // uniform_tile_spacing_flag
    fh.tile_cols_log2 = min_log2_tile_cols;
    while (fh.tile_cols_log2 < max_log2_tile_cols && br.f(1)) ++fh.tile_cols_log2;
    const int tw = (sb_cols + (1 << fh.tile_cols_log2) - 1) >> fh.tile_cols_log2;
    for (int s = 0; s < sb_cols; s += tw) fh.mi_col_starts.push_back(s << sb_shift);
    fh.mi_col_starts.push_back(fh.mi_cols);
    const int min_log2_tile_rows = std::max(min_log2_tiles - fh.tile_cols_log2, 0);
    fh.tile_rows_log2 = min_log2_tile_rows;
    while (fh.tile_rows_log2 < max_log2_tile_rows && br.f(1)) ++fh.tile_rows_log2;
    const int th = (sb_rows + (1 << fh.tile_rows_log2) - 1) >> fh.tile_rows_log2;
    for (int s = 0; s < sb_rows; s += th) fh.mi_row_starts.push_back(s << sb_shift);
    fh.mi_row_starts.push_back(fh.mi_rows);
  } else {
    int widest = 0, s = 0;
    while (s < sb_cols) {
      fh.mi_col_starts.push_back(s << sb_shift);
      const int size = int(br.ns(uint32_t(std::min(sb_cols - s, max_tile_width_sb)))) + 1;
      widest = std::max(widest, size);
      s += size;
      if (br.over || fh.mi_col_starts.size() > 64) return kBadData;
    }
    fh.mi_col_starts.push_back(fh.mi_cols);
    fh.tile_cols_log2 = tile_log2(1, int(fh.mi_col_starts.size()) - 1);
    max_tile_area_sb = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1) : sb_rows * sb_cols;
    const int max_tile_height_sb = std::max(max_tile_area_sb / widest, 1);
    s = 0;
    while (s < sb_rows) {
      fh.mi_row_starts.push_back(s << sb_shift);
      s += int(br.ns(uint32_t(std::min(sb_rows - s, max_tile_height_sb)))) + 1;
      if (br.over || fh.mi_row_starts.size() > 64) return kBadData;
    }
    fh.mi_row_starts.push_back(fh.mi_rows);
    fh.tile_rows_log2 = tile_log2(1, int(fh.mi_row_starts.size()) - 1);
  }
  fh.tile_cols = int(fh.mi_col_starts.size()) - 1;
  fh.tile_rows = int(fh.mi_row_starts.size()) - 1;
  if (fh.tile_cols_log2 > 0 || fh.tile_rows_log2 > 0) {
    br.f(fh.tile_rows_log2 + fh.tile_cols_log2);  // context_update_tile_id
    fh.tile_size_bytes = int(br.f(2)) + 1;
  }
  // quantization_params()
  fh.base_q_idx = int(br.f(8));
  int dq[5] = {read_delta_q(br), 0, 0, 0, 0};
  if (!sh.mono) {
    const int diff_uv_delta = sh.separate_uv_delta_q ? int(br.f(1)) : 0;
    dq[1] = read_delta_q(br);
    dq[2] = read_delta_q(br);
    if (diff_uv_delta) {
      dq[3] = read_delta_q(br);
      dq[4] = read_delta_q(br);
    } else {
      dq[3] = dq[1];
      dq[4] = dq[2];
    }
  }
  if (br.f(1)) {  // using_qmatrix
    br.f(8);
    if (sh.separate_uv_delta_q) br.f(4);
  }
  fh.segmentation = int(br.f(1));
  if (fh.segmentation) return kUnsupported;
  fh.coded_lossless = fh.base_q_idx == 0 && !dq[0] && !dq[1] && !dq[2] && !dq[3] && !dq[4];
  if (!fh.coded_lossless) return kUnsupported;  // lossy quantisation is not ported
  // delta_q_params() and delta_lf_params() read nothing at base_q_idx 0; the loop filter, CDEF and loop
  // restoration params nothing in a coded lossless frame (AllLossless: no superres); read_tx_mode()
  // nothing (ONLY_4X4); the reference mode, skip mode, warped motion and global motion nothing in a key frame
  br.f(1);  // reduced_tx_set
  if (sh.film_grain_present && (show_frame || showable_frame)) fh.apply_grain = int(br.f(1));
  if (fh.apply_grain) return kUnsupported;
  if (sh.bit_depth != 8) return kUnsupported;
  if (br.over) return kBadData;
  return kOk;
}

// The frame being decoded: its planes, the mode info per 4x4, the tile's contexts
struct Frame {
  const SequenceHeader* sh;
  const FrameHeader* fh;
  int ssx, ssy, nplanes;
  int stride[3], rows[3];
  std::vector<uint8_t> px[3];
  std::vector<uint8_t> ymode, uvmode, misize, skipf;  // by mi row * mi_cols + mi col
  // the tile
  int r0, r1, c0, c1;
  Cdfs cdf;
  SymbolDecoder sd;
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  uint8_t decoded[3][34][34];  // BlockDecoded[plane][y + 1][x + 1]
  // the block
  int mi_row, mi_col, mi_size, has_chroma, avail_u, avail_l, avail_u_chroma, avail_l_chroma, skip;
  int y_mode, uv_mode, angle_y, angle_uv, use_filter_intra, filter_intra_mode, cfl_u, cfl_v;
  int max_luma_w, max_luma_h;
  bool failed = false;

  uint8_t& at(int plane, int y, int x) { return px[plane][size_t(y) * stride[plane] + x]; }
  bool inside(int r, int c) const { return c >= c0 && c < c1 && r >= r0 && r < r1; }
  int mi(int r, int c) const { return r * fh->mi_cols + c; }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int plane = 0; plane < nplanes; ++plane) {
      const int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
      const int w4 = (c1 - c) >> sx, h4 = (r1 - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); ++y)
        for (int x = -1; x <= (sb4 >> sx); ++x)
          decoded[plane][y + 1][x + 1] = (y < 0 && x < w4) ? 1 : (x < 0 && y < h4) ? 1 : 0;
      decoded[plane][(sb4 >> sy) + 1][0] = 0;
    }
  }

  void decode_partition(int r, int c, int bsize) {
    if (failed || r >= fh->mi_rows || c >= fh->mi_cols) return;
    const int avail_up = inside(r - 1, c), avail_left = inside(r, c - 1);
    const int n4 = kW4[bsize], half = n4 >> 1, quarter = half >> 1;
    const bool has_rows = (r + half) < fh->mi_rows, has_cols = (c + half) < fh->mi_cols;
    int partition;
    if (bsize < B8x8) {
      partition = PNone;
    } else {
      const int bsl = floor_log2(uint32_t(n4));
      const int above = avail_up && floor_log2(kW4[misize[mi(r - 1, c)]]) < bsl;
      const int left = avail_left && floor_log2(kH4[misize[mi(r, c - 1)]]) < bsl;
      uint16_t* pc = cdf.partition[(bsl - 1) * 4 + left * 2 + above];
      const int N = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      if (has_rows && has_cols) {
        partition = sd.symbol(pc, N);
      } else if (has_cols || has_rows) {
        // split_or_horz / split_or_vert: a bool whose chance of 1 is the summed chance of the partitions
        // that split the half kept
        auto p = [&](int k) { return int(k ? pc[k - 1] : 32768) - int(k < N - 1 ? pc[k] : 0); };
        int psum;
        if (has_cols)
          psum = p(PVert) + p(PSplit) + p(PHorzA) + p(PVertA) + p(PVertB) + (bsize != B128x128 ? p(PVert4) : 0);
        else
          psum = p(PHorz) + p(PSplit) + p(PHorzA) + p(PHorzB) + p(PVertA) + (bsize != B128x128 ? p(PHorz4) : 0);
        const uint16_t b[3] = {uint16_t(psum), 0, 0};
        partition = sd.decode(b, 2) ? PSplit : (has_cols ? PHorz : PVert);
      } else {
        partition = PSplit;
      }
    }
    const int sub = subsize(partition, bsize), split = subsize(PSplit, bsize);
    if (sub == kBlockInvalid) {
      failed = true;
      return;
    }
    switch (partition) {
      case PNone: decode_block(r, c, sub); break;
      case PHorz:
        decode_block(r, c, sub);
        if (has_rows) decode_block(r + half, c, sub);
        break;
      case PVert:
        decode_block(r, c, sub);
        if (has_cols) decode_block(r, c + half, sub);
        break;
      case PSplit:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case PHorzA:
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, sub);
        break;
      case PHorzB:
        decode_block(r, c, sub);
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case PVertA:
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, sub);
        break;
      case PVertB:
        decode_block(r, c, sub);
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case PHorz4:
        for (int k = 0; k < 4; ++k)
          if (k < 3 || r + quarter * 3 < fh->mi_rows) decode_block(r + quarter * k, c, sub);
        break;
      default:
        for (int k = 0; k < 4; ++k)
          if (k < 3 || c + quarter * 3 < fh->mi_cols) decode_block(r, c + quarter * k, sub);
        break;
    }
  }

  void read_cfl_alphas() {
    const int signs = sd.symbol(cdf.cfl_sign[0], 8);
    const int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
    cfl_u = cfl_v = 0;
    if (sign_u) {
      cfl_u = 1 + sd.symbol(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
      if (sign_u == 1) cfl_u = -cfl_u;
    }
    if (sign_v) {
      cfl_v = 1 + sd.symbol(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
      if (sign_v == 1) cfl_v = -cfl_v;
    }
  }

  void decode_block(int r, int c, int bsize) {
    if (failed) return;
    mi_row = r;
    mi_col = c;
    mi_size = bsize;
    const int bw4 = kW4[bsize], bh4 = kH4[bsize];
    if (bh4 == 1 && ssy && (r & 1) == 0)
      has_chroma = 0;
    else if (bw4 == 1 && ssx && (c & 1) == 0)
      has_chroma = 0;
    else
      has_chroma = nplanes > 1;
    avail_u = inside(r - 1, c);
    avail_l = inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (ssy && bh4 == 1) avail_u_chroma = inside(r - 2, c);
      if (ssx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = 0;
    }
    // intra_frame_mode_info()
    skip = sd.symbol(cdf.skip[(avail_u ? skipf[mi(r - 1, c)] : 0) + (avail_l ? skipf[mi(r, c - 1)] : 0)], 2);
    const int above_mode = avail_u ? int(ymode[mi(r - 1, c)]) : int(DC_PRED);
    const int left_mode = avail_l ? int(ymode[mi(r, c - 1)]) : int(DC_PRED);
    y_mode = sd.symbol(cdf.kf_y[kIntraModeContext[above_mode]][kIntraModeContext[left_mode]], 13);
    angle_y = angle_uv = 0;
    if (bsize >= B8x8 && y_mode >= V_PRED && y_mode <= D67_PRED)
      angle_y = sd.symbol(cdf.angle[y_mode - V_PRED], 7) - 3;
    uv_mode = DC_PRED;
    if (has_chroma) {
      const int cfl_allowed = plane_size(bsize, ssx, ssy) == B4x4;
      if (cfl_allowed)
        uv_mode = sd.symbol(cdf.uv_cfl[y_mode], 14);
      else
        uv_mode = sd.symbol(cdf.uv_no_cfl[y_mode], 13);
      if (uv_mode == UV_CFL_PRED) read_cfl_alphas();
      if (bsize >= B8x8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
        angle_uv = sd.symbol(cdf.angle[uv_mode - V_PRED], 7) - 3;
    }
    use_filter_intra = 0;
    if (sh->enable_filter_intra && y_mode == DC_PRED && std::max(bw4, bh4) <= 8) {
      use_filter_intra = sd.symbol(cdf.fi[bsize], 2);
      if (use_filter_intra) filter_intra_mode = sd.symbol(cdf.fi_mode[0], 5);
    }
    // read_block_tx_size(): TX_4X4 in a lossless frame
    if (skip) {  // reset_block_context()
      for (int plane = 0; plane < 1 + 2 * has_chroma; ++plane) {
        const int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
        for (int i = c >> sx; i < ((c + bw4) >> sx); ++i) above_level[plane][i] = above_dc[plane][i] = 0;
        for (int i = r >> sy; i < ((r + bh4) >> sy); ++i) left_level[plane][i] = left_dc[plane][i] = 0;
      }
    }
    for (int y = 0; y < bh4; ++y) {
      if (r + y >= fh->mi_rows) break;
      for (int x = 0; x < bw4 && c + x < fh->mi_cols; ++x) {
        const int k = mi(r + y, c + x);
        ymode[k] = uint8_t(y_mode);
        if (has_chroma) uvmode[k] = uint8_t(uv_mode);
        misize[k] = uint8_t(bsize);
        skipf[k] = uint8_t(skip);
      }
    }
    residual();
  }

  void residual() {
    const int wchunks = std::max(1, kW4[mi_size] >> 4), hchunks = std::max(1, kH4[mi_size] >> 4);
    for (int cy = 0; cy < hchunks; ++cy)
      for (int cx = 0; cx < wchunks; ++cx) {
        for (int plane = 0; plane < 1 + 2 * has_chroma; ++plane) {
          const int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
          const int psz = plane_size(mi_size, sx, sy);
          if (psz == kBlockInvalid) {
            failed = true;
            return;
          }
          const int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
          for (int y = 0; y < std::min<int>(kH4[psz], 16 >> sy); ++y)
            for (int x = 0; x < std::min<int>(kW4[psz], 16 >> sx); ++x)
              transform_block(plane, base_x, base_y, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
        }
      }
  }

  int get_filter_type(int plane) {
    auto smooth = [&](int r, int c) {
      const int m = plane == 0 ? ymode[mi(r, c)] : uvmode[mi(r, c)];
      return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
    };
    int a = 0, l = 0;
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (ssx && !(mi_col & 1)) ++c;
        if (ssy && (mi_row & 1)) --r;
      }
      a = smooth(r, c);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (ssx && (mi_col & 1)) --c;
        if (ssy && !(mi_row & 1)) ++r;
      }
      l = smooth(r, c);
    }
    return a || l;
  }

  void transform_block(int plane, int base_x, int base_y, int x, int y) {
    const int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    const int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    const int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    const int sb_mask = sh->use_128 ? 31 : 15;
    const int sub_row = (row & sb_mask) >> sy, sub_col = (col & sb_mask) >> sx;
    const int max_x = (fh->mi_cols * 4) >> sx, max_y = (fh->mi_rows * 4) >> sy;
    if (start_x >= max_x || start_y >= max_y) return;
    const int is_cfl = plane > 0 && uv_mode == UV_CFL_PRED;
    const int mode = plane == 0 ? y_mode : (is_cfl ? DC_PRED : uv_mode);
    const int have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
    const int have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
    const int have_above_rt = decoded[plane][sub_row][sub_col + 1 + 1];
    const int have_below_lt = decoded[plane][sub_row + 1 + 1][sub_col];
    predict_intra(plane, start_x, start_y, have_left, have_above, have_above_rt, have_below_lt, mode);
    if (is_cfl) predict_cfl(plane, start_x, start_y);
    if (plane == 0) {
      max_luma_w = start_x + 4;
      max_luma_h = start_y + 4;
    }
    if (!skip) {
      int32_t q[16];
      if (coeffs(plane, start_x, start_y, q)) reconstruct(plane, start_x, start_y, q);
    }
    decoded[plane][sub_row + 1][sub_col + 1] = 1;
  }

  void predict_intra(int plane, int x, int y, int have_left, int have_above, int have_above_rt, int have_below_lt,
                     int mode) {
    const int w = 4, h = 4, bd = 8;
    const int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    const int max_x = ((fh->mi_cols * 4) >> sx) - 1, max_y = ((fh->mi_rows * 4) >> sy) - 1;
    int above_buf[48], left_buf[48];
    int* above = above_buf + 16;
    int* left = left_buf + 16;
    for (int i = 0; i < w + h; ++i) {
      if (!have_above && have_left)
        above[i] = at(plane, y, x - 1);
      else if (!have_above)
        above[i] = (1 << (bd - 1)) - 1;
      else
        above[i] = at(plane, y - 1, std::min(std::min(max_x, x + (have_above_rt ? 2 * w : w) - 1), x + i));
      if (!have_left && have_above)
        left[i] = at(plane, y - 1, x);
      else if (!have_left)
        left[i] = (1 << (bd - 1)) + 1;
      else
        left[i] = at(plane, std::min(std::min(max_y, y + (have_below_lt ? 2 * h : h) - 1), y + i), x - 1);
    }
    if (have_above && have_left)
      above[-1] = at(plane, y - 1, x - 1);
    else if (have_above)
      above[-1] = at(plane, y - 1, x);
    else if (have_left)
      above[-1] = at(plane, y, x - 1);
    else
      above[-1] = 1 << (bd - 1);
    left[-1] = above[-1];
    int pred[4][4];
    if (plane == 0 && use_filter_intra) {
      for (int i2 = 0; i2 < h / 2; ++i2)
        for (int j4 = 0; j4 < w / 4; ++j4) {
          int p[7];
          for (int i = 0; i < 7; ++i) {
            if (i < 5) {
              if (i2 == 0)
                p[i] = above[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0)
                p[i] = left[(i2 << 1) - 1];
              else
                p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
            } else {
              if (j4 == 0)
                p[i] = left[(i2 << 1) + i - 5];
              else
                p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
            }
          }
          for (int i = 0; i < 8; ++i) {
            int pr = 0;
            for (int j = 0; j < 7; ++j) pr += kFilterIntraTaps[filter_intra_mode][i][j] * p[j];
            const int v = pr >= 0 ? (pr + 8) >> 4 : -((-pr + 8) >> 4);
            pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = std::clamp(v, 0, 255);
          }
        }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      const int angle = kModeToAngle[mode] + (plane == 0 ? angle_y : angle_uv) * 3;
      int up_above = 0, up_left = 0;
      if (sh->enable_intra_edge_filter) {
        if (angle != 90 && angle != 180) {
          const int filter_type = get_filter_type(plane);
          if (angle > 90 && angle < 180 && (w + h) >= 24) {
            const int v = (left[0] * 5 + above[-1] * 6 + above[0] * 5 + 8) >> 4;
            left[-1] = above[-1] = v;
          }
          if (have_above) {
            const int strength = edge_strength(w, h, filter_type, angle - 90);
            const int n = std::min(w, max_x - x + 1) + (angle < 90 ? h : 0) + 1;
            edge_filter(above, n, strength);
          }
          if (have_left) {
            const int strength = edge_strength(w, h, filter_type, angle - 180);
            const int n = std::min(h, max_y - y + 1) + (angle > 180 ? w : 0) + 1;
            edge_filter(left, n, strength);
          }
          up_above = use_upsample(w, h, filter_type, angle - 90);
          if (up_above) upsample(above, w + (angle < 90 ? h : 0));
          up_left = use_upsample(w, h, filter_type, angle - 180);
          if (up_left) upsample(left, h + (angle > 180 ? w : 0));
        }
      }
      int dx = 0, dy = 0;
      if (angle < 90)
        dx = kDrIntraDerivative[angle];
      else if (angle > 90 && angle < 180)
        dx = kDrIntraDerivative[180 - angle];
      if (angle > 90 && angle < 180)
        dy = kDrIntraDerivative[angle - 90];
      else if (angle > 180)
        dy = kDrIntraDerivative[270 - angle];
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          int v;
          if (angle < 90) {
            const int idx = (i + 1) * dx;
            const int base = (idx >> (6 - up_above)) + (j << up_above);
            const int shift = ((idx << up_above) >> 1) & 0x1F;
            const int max_base = (w + h - 1) << up_above;
            v = base < max_base ? (above[base] * (32 - shift) + above[base + 1] * shift + 16) >> 5 : above[max_base];
          } else if (angle > 90 && angle < 180) {
            const int idx = (j << 6) - (i + 1) * dx;
            const int base = idx >> (6 - up_above);
            if (base >= -(1 << up_above)) {
              const int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
              v = (above[base] * (32 - shift) + above[base + 1] * shift + 16) >> 5;
            } else {
              const int idy = (i << 6) - (j + 1) * dy;
              const int basey = std::max(idy >> (6 - up_left), -16);  // >= -(1 << up_left) for every AV1 angle
              const int shift = ((idy * (1 << up_left)) >> 1) & 0x1F;
              v = (left[basey] * (32 - shift) + left[basey + 1] * shift + 16) >> 5;
            }
          } else if (angle > 180) {
            const int idx = (j + 1) * dy;
            const int base = (idx >> (6 - up_left)) + (i << up_left);
            const int shift = ((idx << up_left) >> 1) & 0x1F;
            const int max_base = (w + h - 1) << up_left;
            v = base < max_base ? (left[base] * (32 - shift) + left[base + 1] * shift + 16) >> 5 : left[max_base];
          } else if (angle == 90) {
            v = above[j];
          } else {
            v = left[i];
          }
          pred[i][j] = v;
        }
    } else if (mode == SMOOTH_PRED) {
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          const int s = kSmWeights4[i] * above[j] + (256 - kSmWeights4[i]) * left[h - 1] + kSmWeights4[j] * left[i] +
                        (256 - kSmWeights4[j]) * above[w - 1];
          pred[i][j] = (s + 256) >> 9;
        }
    } else if (mode == SMOOTH_V_PRED) {
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j)
          pred[i][j] = (kSmWeights4[i] * above[j] + (256 - kSmWeights4[i]) * left[h - 1] + 128) >> 8;
    } else if (mode == SMOOTH_H_PRED) {
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j)
          pred[i][j] = (kSmWeights4[j] * left[i] + (256 - kSmWeights4[j]) * above[w - 1] + 128) >> 8;
    } else if (mode == DC_PRED) {
      int avg;
      if (have_above && have_left) {
        int sum = 0;
        for (int k = 0; k < w; ++k) sum += above[k];
        for (int k = 0; k < h; ++k) sum += left[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; ++k) sum += left[k];
        avg = (sum + (h >> 1)) >> 2;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; ++k) sum += above[k];
        avg = (sum + (w >> 1)) >> 2;
      } else {
        avg = 1 << (bd - 1);
      }
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) pred[i][j] = avg;
    } else {  // PAETH_PRED
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          const int base = above[j] + left[i] - above[-1];
          const int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]), ptl = std::abs(base - above[-1]);
          pred[i][j] = (pl <= pt && pl <= ptl) ? left[i] : (pt <= ptl) ? above[j] : above[-1];
        }
    }
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) at(plane, y + i, x + j) = uint8_t(pred[i][j]);
  }

  static int edge_strength(int w, int h, int filter_type, int delta) {
    const int d = std::abs(delta), wh = w + h;
    int s = 0;
    if (filter_type == 0) {
      if (wh <= 8) {
        if (d >= 56) s = 1;
      } else if (wh <= 16) {
        if (d >= 40) s = 1;
      } else if (wh <= 24) {
        if (d >= 8) s = 1;
        if (d >= 16) s = 2;
        if (d >= 32) s = 3;
      } else if (wh <= 32) {
        if (d >= 1) s = 1;
        if (d >= 4) s = 2;
        if (d >= 32) s = 3;
      } else if (d >= 1) {
        s = 3;
      }
    } else {
      if (wh <= 8) {
        if (d >= 40) s = 1;
        if (d >= 64) s = 2;
      } else if (wh <= 16) {
        if (d >= 20) s = 1;
        if (d >= 48) s = 2;
      } else if (wh <= 24) {
        if (d >= 4) s = 3;
      } else if (d >= 1) {
        s = 3;
      }
    }
    return s;
  }

  static int use_upsample(int w, int h, int filter_type, int delta) {
    const int d = std::abs(delta), wh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return filter_type ? wh <= 8 : wh <= 16;
  }

  // 7.11.2.12 on buf[-1 .. sz - 2]
  static void edge_filter(int* buf, int sz, int strength) {
    if (!strength) return;
    int edge[40];
    for (int i = 0; i < sz; ++i) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; ++i) {
      int s = 0;
      for (int j = 0; j < 5; ++j) s += kIntraEdgeKernel[strength - 1][j] * edge[std::clamp(i - 2 + j, 0, sz - 1)];
      buf[i - 1] = (s + 8) >> 4;
    }
  }

  // 7.11.2.11
  static void upsample(int* buf, int n) {
    int dup[40];
    dup[0] = buf[-1];
    for (int i = -1; i < n; ++i) dup[i + 2] = buf[i];
    dup[n + 2] = buf[n - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < n; ++i) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = std::clamp((s + 8) >> 4, 0, 255);
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  // 7.11.5 for a 4x4 chroma transform block
  void predict_cfl(int plane, int sx0, int sy0) {
    const int alpha = plane == 1 ? cfl_u : cfl_v;
    int l[4][4], sum = 0;
    for (int i = 0; i < 4; ++i) {
      const int ly = std::min(sy0 + i, (max_luma_h >> ssy) - 1);
      for (int j = 0; j < 4; ++j) {
        const int lx = std::min(sx0 + j, (max_luma_w >> ssx) - 1);
        int t = 0;
        for (int dy = 0; dy <= ssy; ++dy)
          for (int dx = 0; dx <= ssx; ++dx) t += at(0, (ly << ssy) + dy, (lx << ssx) + dx);
        l[i][j] = t << (3 - ssx - ssy);
        sum += l[i][j];
      }
    }
    const int avg = (sum + 8) >> 4;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int s = alpha * (l[i][j] - avg);
        const int scaled = s >= 0 ? (s + 32) >> 6 : -((-s + 32) >> 6);
        uint8_t& p = at(plane, sy0 + i, sx0 + j);
        p = uint8_t(std::clamp(int(p) + scaled, 0, 255));
      }
  }

  // coeffs() of a 4x4 transform block: the dequantised coefficients in q (row major); false when all zero
  bool coeffs(int plane, int start_x, int start_y, int32_t* q) {
    const int x4 = start_x >> 2, y4 = start_y >> 2;
    const int sx = plane ? ssx : 0, sy = plane ? ssy : 0;
    const int max_x4 = fh->mi_cols >> sx, max_y4 = fh->mi_rows >> sy;
    const int ptype = plane > 0;
    int ctx;
    if (plane == 0) {
      const int top = std::min<int>(x4 < max_x4 ? above_level[0][x4] : 0, 255);
      const int lft = std::min<int>(y4 < max_y4 ? left_level[0][y4] : 0, 255);
      if (mi_size == B4x4)
        ctx = 0;
      else if (top == 0 && lft == 0)
        ctx = 1;
      else if (top == 0 || lft == 0)
        ctx = 2 + (std::max(top, lft) > 3);
      else if (std::max(top, lft) <= 3)
        ctx = 4;
      else if (std::min(top, lft) <= 3)
        ctx = 5;
      else
        ctx = 6;
    } else {
      int a = 0, l = 0;
      if (x4 < max_x4) a = above_level[plane][x4] | above_dc[plane][x4];
      if (y4 < max_y4) l = left_level[plane][y4] | left_dc[plane][y4];
      ctx = 7 + (a != 0) + (l != 0);
      const int psz = plane_size(mi_size, sx, sy);
      if (kW4[psz] * kH4[psz] > 1) ctx += 3;
    }
    int level[16] = {0};
    int cul = 0, dc_cat = 0, eob = 0;
    const int all_zero = sd.symbol(cdf.txb_skip[ctx], 2);
    if (!all_zero) {
      const int eob_pt = sd.symbol(cdf.eob16[ptype][0], 5) + 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int shift = eob_pt - 3;
      if (shift >= 0) {
        if (sd.symbol(cdf.eob_extra[ptype][eob_pt - 3], 2)) eob += 1 << shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); ++i) {
          shift = std::max(0, eob_pt - 2) - 1 - i;
          if (sd.boolean()) eob += 1 << shift;
        }
      }
      for (int c = eob - 1; c >= 0; --c) {
        const int pos = kDefaultScan4x4[c];
        int lv;
        if (c == eob - 1) {
          const int e = c == 0 ? 0 : c <= 2 ? 1 : c <= 4 ? 2 : 3;
          lv = sd.symbol(cdf.base_eob[ptype][e], 3) + 1;
        } else {
          lv = sd.symbol(cdf.base[ptype][base_ctx(level, pos)], 4);
        }
        if (lv > 2) {
          const int bctx = br_ctx(level, pos);
          for (int k = 0; k < 4; ++k) {
            const int b = sd.symbol(cdf.br[ptype][bctx], 4);
            lv += b;
            if (b < 3) break;
          }
        }
        level[pos] = lv;
      }
      for (int c = 0; c < eob; ++c) {
        const int pos = kDefaultScan4x4[c];
        int sign = 0;
        if (level[pos]) {
          if (c == 0) {
            int dcs = 0;
            if (x4 < max_x4) dcs += above_dc[plane][x4] == 1 ? -1 : above_dc[plane][x4] == 2 ? 1 : 0;
            if (y4 < max_y4) dcs += left_dc[plane][y4] == 1 ? -1 : left_dc[plane][y4] == 2 ? 1 : 0;
            sign = sd.symbol(cdf.dc_sign[ptype][dcs < 0 ? 1 : dcs > 0 ? 2 : 0], 2);
          } else {
            sign = sd.boolean();
          }
        }
        int v = level[pos];
        if (v > 14) {
          int length = 0, bit;
          do {
            ++length;
            bit = sd.boolean();
            if (length > 32) {
              failed = true;
              return false;
            }
          } while (!bit);
          int x = 1;
          for (int i = length - 2; i >= 0; --i) x = (x << 1) | sd.boolean();
          v = x + 14;
        }
        if (pos == 0 && v > 0) dc_cat = sign ? 1 : 2;
        v &= 0xFFFFF;
        cul += v;
        level[pos] = sign ? -v : v;
      }
      cul = std::min(63, cul);
    }
    above_level[plane][x4] = uint8_t(cul);
    above_dc[plane][x4] = uint8_t(dc_cat);
    left_level[plane][y4] = uint8_t(cul);
    left_dc[plane][y4] = uint8_t(dc_cat);
    if (all_zero) return false;
    for (int i = 0; i < 16; ++i) {
      // dequantisation at q index 0 (the 8-bit DC and AC quantisers are 4)
      const int a = std::abs(level[i]);
      int dq = (a * 4) & 0xFFFFFF;
      if (level[i] < 0) dq = -dq;
      q[i] = std::clamp(dq, -(1 << 15), (1 << 15) - 1);
    }
    return true;
  }

  static int base_ctx(const int* level, int pos) {
    const int row = pos >> 2, col = pos & 3;
    static const int off[5][2] = {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}};
    int mag = 0;
    for (auto& o : off) {
      const int rr = row + o[0], cc = col + o[1];
      if (rr < 4 && cc < 4) mag += std::min(std::abs(level[rr * 4 + cc]), 3);
    }
    if (pos == 0) return 0;
    return std::min((mag + 1) >> 1, 4) + kCoeffBaseCtxOffset4x4[std::min(row, 4)][std::min(col, 4)];
  }

  static int br_ctx(const int* level, int pos) {
    const int row = pos >> 2, col = pos & 3;
    static const int off[3][2] = {{0, 1}, {1, 0}, {1, 1}};
    int mag = 0;
    for (auto& o : off) {
      const int rr = row + o[0], cc = col + o[1];
      if (rr < 4 && cc < 4) mag += std::min(level[rr * 4 + cc], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row < 2 && col < 2) return mag + 7;
    return mag + 14;
  }

  // the inverse WHT (rows with shift 2, then columns) and the residual added
  void reconstruct(int plane, int x, int y, const int32_t* q) {
    int r[4][4];
    for (int i = 0; i < 4; ++i) {
      int t[4] = {q[i * 4], q[i * 4 + 1], q[i * 4 + 2], q[i * 4 + 3]};
      wht(t, 2);
      for (int j = 0; j < 4; ++j) r[i][j] = t[j];
    }
    for (int j = 0; j < 4; ++j) {
      int t[4] = {r[0][j], r[1][j], r[2][j], r[3][j]};
      wht(t, 0);
      for (int i = 0; i < 4; ++i) r[i][j] = t[i];
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        uint8_t& p = at(plane, y + i, x + j);
        p = uint8_t(std::clamp(int(p) + r[i][j], 0, 255));
      }
  }

  static void wht(int* t, int shift) {
    int a = t[0] >> shift, c = t[1] >> shift, d = t[2] >> shift, b = t[3] >> shift;
    a += c;
    d -= b;
    const int e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    t[0] = a;
    t[1] = b;
    t[2] = c;
    t[3] = d;
  }

  int decode_tile(const uint8_t* data, int64_t size, int tile_row, int tile_col) {
    r0 = fh->mi_row_starts[tile_row];
    r1 = fh->mi_row_starts[tile_row + 1];
    c0 = fh->mi_col_starts[tile_col];
    c1 = fh->mi_col_starts[tile_col + 1];
    cdf = Cdfs();
    sd.init(data, size, fh->disable_cdf_update);
    for (int p = 0; p < nplanes; ++p) {
      std::fill(above_level[p].begin(), above_level[p].end(), 0);
      std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
    }
    const int sb4 = sh->use_128 ? 32 : 16;
    for (int r = r0; r < r1; r += sb4) {
      for (int p = 0; p < nplanes; ++p) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = c0; c < c1; c += sb4) {
        clear_block_decoded(r, c, sb4);
        decode_partition(r, c, sh->use_128 ? B128x128 : B64x64);
        if (failed) return kBadData;
      }
      // dav1d fails a superblock row after which the symbol decoder has read 15 or more bits past the tile
      if (sd.maxbits <= -15) return kBadData;
    }
    return kOk;
  }
};

struct Decoded {
  SequenceHeader sh;
  FrameHeader fh;
  bool have_frame = false;
};

// Walks the OBUs: the sequence header, then the first frame (its header and tile groups). With
// planes, decodes the frame into them, and reads the headers of the OBUs after it as dav1d does.
// Returns kOk, kBadData or kUnsupported.
int walk(const uint8_t* data, int64_t n, Decoded& d, Frame* frame) {
  int64_t pos = 0;
  int tiles_done = 0;
  bool done = false;  // the first frame decoded
  while (pos < n) {
    BitReader br{data + pos, n - pos};
    br.f(1);  // forbidden bit
    const int type = int(br.f(4));
    const int ext = int(br.f(1));
    const int has_size = int(br.f(1));
    br.f(1);
    int temporal_id = 0, spatial_id = 0;
    if (ext) {
      temporal_id = int(br.f(3));
      spatial_id = int(br.f(2));
      br.f(3);
    }
    int64_t size;
    if (has_size)
      size = int64_t(br.leb128());
    else
      size = n - pos - 1 - ext;
    if (br.over) return kBadData;
    const int64_t hdr = br.pos / 8;
    if (size < 0 || size > n - pos - hdr) return kBadData;
    const uint8_t* obu = data + pos + hdr;
    pos += hdr + size;
    if (done) {
      // dav1d goes on parsing the OBUs after the frame (a frame of its own is not decoded here)
      if (type == 4) return kBadData;  // a tile group without a frame header
      if (type == 1 || type == 3 || type == 6) {
        SequenceHeader sh = d.sh;
        FrameHeader fh;
        BitReader b{obu, size};
        if ((type == 1 ? parse_sequence_header(b, sh) : parse_frame_header(b, sh, fh, temporal_id, spatial_id)) ==
            kBadData)
          return kBadData;
      }
      continue;
    }
    if (type == 1) {  // sequence header
      BitReader sb{obu, size};
      const int rc = parse_sequence_header(sb, d.sh);
      if (rc) return rc;
      continue;
    }
    if (!d.sh.seen) {
      if (type == 3 || type == 4 || type == 6) return kBadData;  // dav1d: a frame before any sequence header
      continue;
    }
    if (ext && d.sh.op_idc[0]) {  // not in operating point 0
      const int idc = d.sh.op_idc[0];
      if (!((idc >> temporal_id) & 1) || !((idc >> (spatial_id + 8)) & 1)) continue;
    }
    if (type == 3 || type == 6) {  // frame header, frame
      if (d.have_frame) {
        if (type == 3) continue;  // a redundant copy
        return kBadData;
      }
      BitReader fb{obu, size};
      const int rc = parse_frame_header(fb, d.sh, d.fh, temporal_id, spatial_id);
      d.have_frame = rc == kOk || (rc == kUnsupported && d.fh.w > 0);  // info reports a refused frame too
      if (rc) return rc;
      if (!frame) return kOk;
      if (type == 3) continue;
      fb.byte_align();
      const int64_t off = fb.pos / 8;
      if (off > size) return kBadData;
      obu += off;
      size -= off;
    } else if (type != 4) {
      continue;  // temporal delimiter, metadata, padding, tile list
    }
    if (!d.have_frame || !frame) continue;
    // tile_group_obu()
    const FrameHeader& fh = d.fh;
    const int ntiles = fh.tile_cols * fh.tile_rows;
    BitReader tb{obu, size};
    int tg_start = 0, tg_end = ntiles - 1;
    if (ntiles > 1 && tb.f(1)) {
      const int bits = fh.tile_cols_log2 + fh.tile_rows_log2;
      tg_start = int(tb.f(bits));
      tg_end = int(tb.f(bits));
    }
    tb.byte_align();
    if (tb.over || tg_start != tiles_done || tg_end < tg_start || tg_end >= ntiles) return kBadData;
    int64_t at = tb.pos / 8;
    for (int t = tg_start; t <= tg_end; ++t) {
      int64_t tsize;
      if (t == tg_end) {
        tsize = size - at;
      } else {
        if (at + fh.tile_size_bytes > size) return kBadData;
        tsize = 0;
        for (int k = 0; k < fh.tile_size_bytes; ++k) tsize |= int64_t(obu[at + k]) << (8 * k);
        tsize += 1;
        at += fh.tile_size_bytes;
      }
      if (tsize <= 0 || tsize > size - at) return kBadData;
      const int rc = frame->decode_tile(obu + at, tsize, t / fh.tile_cols, t % fh.tile_cols);
      if (rc) return rc;
      at += tsize;
    }
    tiles_done = tg_end + 1;
    done = tiles_done == ntiles;
  }
  if (!d.sh.seen || !d.have_frame) return kBadData;
  if (frame && tiles_done != d.fh.tile_cols * d.fh.tile_rows) return kBadData;
  return kOk;
}

void fill_info(const Decoded& d, int32_t* info) {
  const SequenceHeader& s = d.sh;
  const int32_t v[13] = {d.fh.w,   d.fh.h,  s.bit_depth, s.mono, s.ssx, s.ssy, s.cp, s.tc, s.mc, s.color_range,
                         d.fh.base_q_idx, s.csp, s.color_description_present};
  std::memcpy(info, v, sizeof v);
}

}  // namespace

extern "C" {

// The first frame's header: info[13] = width, height, bit depth, monochrome, subsampling x and y, colour
// primaries, transfer characteristics, matrix coefficients, colour range, base_q_idx, chroma sample position,
// colour description present. 0, kBadData (-1) or kUnsupported (-2: a frame outside the ported subset whose
// header cannot be read to its end, such as a screen content or segmented one; info holds what was read).
int vkgr_av1_info(const uint8_t* data, int64_t n, int32_t* info) {
  Decoded d;
  std::memset(info, 0, 13 * sizeof(int32_t));
  const int rc = walk(data, n, d, nullptr);
  if (d.sh.seen && d.have_frame) fill_info(d, info);
  return rc;
}

// Decodes the first frame into out: the luma plane (width x height), then each chroma plane at its
// subsampled size, rows packed. info as vkgr_av1_info. 0, kBadData (-1), kUnsupported (-2) or kNoSpace (-3).
int vkgr_av1_decode(const uint8_t* data, int64_t n, int32_t* info, uint8_t* out, int64_t cap) try {
  Decoded d;
  std::memset(info, 0, 13 * sizeof(int32_t));
  int rc = walk(data, n, d, nullptr);
  if (rc) return rc;
  fill_info(d, info);
  const SequenceHeader& sh = d.sh;
  const FrameHeader& fh = d.fh;
  const int nplanes = sh.mono ? 1 : 3;
  const int64_t cw = (int64_t(fh.w) + sh.ssx) >> sh.ssx, ch = (int64_t(fh.h) + sh.ssy) >> sh.ssy;
  const int64_t need = int64_t(fh.w) * fh.h + (nplanes > 1 ? 2 * cw * ch : 0);
  if (need > cap) return kNoSpace;
  Frame f;
  f.sh = &sh;
  f.fh = &fh;
  f.ssx = sh.ssx;
  f.ssy = sh.ssy;
  f.nplanes = nplanes;
  const int64_t mi = int64_t(fh.mi_rows) * fh.mi_cols;
  f.ymode.assign(size_t(mi), 0);
  f.uvmode.assign(size_t(mi), 0);
  f.misize.assign(size_t(mi), 0);
  f.skipf.assign(size_t(mi), 0);
  for (int p = 0; p < nplanes; ++p) {
    const int sx = p ? sh.ssx : 0, sy = p ? sh.ssy : 0;
    f.stride[p] = (fh.mi_cols * 4) >> sx;
    f.rows[p] = (fh.mi_rows * 4) >> sy;
    f.px[p].assign(size_t(f.stride[p]) * f.rows[p], 0);
    f.above_level[p].assign(size_t(fh.mi_cols) + 64, 0);
    f.above_dc[p].assign(size_t(fh.mi_cols) + 64, 0);
    f.left_level[p].assign(size_t(fh.mi_rows) + 64, 0);
    f.left_dc[p].assign(size_t(fh.mi_rows) + 64, 0);
  }
  Decoded d2;
  rc = walk(data, n, d2, &f);
  if (rc) return rc;
  int64_t o = 0;
  for (int p = 0; p < nplanes; ++p) {
    const int64_t w = p ? cw : fh.w, h = p ? ch : fh.h;
    for (int64_t y = 0; y < h; ++y) {
      std::memcpy(out + o, f.px[p].data() + y * f.stride[p], size_t(w));
      o += w;
    }
  }
  return kOk;
} catch (const std::bad_alloc&) {
  return kNoSpace;
}

}  // extern "C"
