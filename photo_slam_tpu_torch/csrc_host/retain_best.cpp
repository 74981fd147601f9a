// OpenCV's KeyPointsFilter::retainBest (modules/features2d/src/
// keypoint.cpp), for the port's ORB (tracking/vision.py).
//
// ORB keeps the best 2n FAST corners of a level and then the best n by the
// Harris response through retainBest, which reorders the keypoints in
// place: std::nth_element puts the n-th best at n - 1 (greater responses
// before it), then std::partition moves the others that tie with it up
// behind it. The order that comes out is whatever the standard library's
// algorithms leave, and it carries meaning downstream (matching follows
// it). Both are header templates, so this file, compiled against the same
// libstdc++, leaves the same order as OpenCV's binary does. The records
// sorted are laid out as cv::KeyPoint (seven 4-byte fields) with the
// input index in class_id; the comparators read the response only.
//
// Plain C interface (tracking/vision.py loads it over ctypes):
//   retain_best(response, n, k, out) -> count
// `response` holds n float32 responses in input order; `out` (room for n)
// receives the input indices that retainBest keeps, in its order. Nothing
// changes when k < 0 or n <= k; k == 0 keeps nothing.

#include <algorithm>
#include <vector>

namespace {

struct KeyPoint {  // cv::KeyPoint
  float x, y, size, angle, response;
  int octave, class_id;
};

struct ResponseGreater {  // KeypointResponseGreater
  bool operator()(const KeyPoint& a, const KeyPoint& b) const {
    return a.response > b.response;
  }
};

struct ResponseAtLeast {  // KeypointResponseGreaterThanOrEqualToThreshold
  float value;
  bool operator()(const KeyPoint& p) const { return p.response >= value; }
};

}  // namespace

extern "C" int retain_best(const float* response, int n, int k, int* out) {
  std::vector<KeyPoint> kps(n);
  for (int i = 0; i < n; ++i)
    kps[i] = KeyPoint{0.f, 0.f, 0.f, -1.f, response[i], 0, i};
  if (k >= 0 && n > k) {
    if (k == 0) return 0;
    std::nth_element(kps.begin(), kps.begin() + k - 1, kps.end(),
                     ResponseGreater());
    const float ambiguous = kps[k - 1].response;
    n = static_cast<int>(std::partition(kps.begin() + k, kps.end(),
                                        ResponseAtLeast{ambiguous}) -
                         kps.begin());
  }
  for (int i = 0; i < n; ++i) out[i] = kps[i].class_id;
  return n;
}
