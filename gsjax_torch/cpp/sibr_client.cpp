// Headless SIBR-protocol remote-render client (native; the port's copy of
// gsjax/cpp/sibr_client.cpp).
//
// The reference bundles the full SIBR_viewers C++ application (~83k LoC,
// OpenGL UI) as its live viewer; the piece that talks to the trainer is its
// RemotePointView network loop. This standalone tool re-implements that
// client side of the wire protocol (gaussian_renderer/network_gui.py:26-86):
//
//   -> 4-byte LE length-prefixed JSON camera message
//   <- width*height*3 raw RGB bytes, then LE length-prefixed verify string
//
// It orbits a camera around the scene origin, requests frames from a running
// `python -m gsjax_torch.train --ip ... --port ...` (the
// gsjax_torch/viewer/network_gui.py server) and writes them as PPM images:
// remote monitoring of a training run from any machine with a C++ compiler,
// no GUI stack required.
//
// Matrix conventions match scene/cameras.py + utils/graphics_utils.py:
// matrices are sent GL-style transposed with Y/Z column flips, exactly what
// NetworkGUI.receive() undoes.
//
// Usage: sibr_client <host> <port> <width> <height> [frames=8]
//                    [out_prefix=frame] [scaling_modifier=1.0] [radius=3.5]

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Mat4 {
  double m[4][4] = {};  // row-major, acts on column vectors
};

Mat4 matmul(const Mat4 &a, const Mat4 &b) {
  Mat4 r;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a.m[i][k] * b.m[k][j];
      r.m[i][j] = s;
    }
  return r;
}

void normalize(double v[3]) {
  double n = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  for (int i = 0; i < 3; ++i) v[i] /= n;
}

void cross(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// world->view for a camera at `pos` looking at the origin, COLMAP y-down
// (data/synth.py ring_pose / scene/cameras.py conventions)
Mat4 look_at_origin(const double pos[3]) {
  double fwd[3] = {-pos[0], -pos[1], -pos[2]};
  normalize(fwd);
  double up[3] = {0.0, -1.0, 0.0};
  double right[3], down[3];
  cross(up, fwd, right);
  normalize(right);
  cross(fwd, right, down);
  Mat4 wv;
  const double *rows[3] = {right, down, fwd};
  for (int i = 0; i < 3; ++i) {
    double t = 0;
    for (int j = 0; j < 3; ++j) {
      wv.m[i][j] = rows[i][j];
      t += rows[i][j] * pos[j];
    }
    wv.m[i][3] = -t;  // t = -R @ pos
  }
  wv.m[3][3] = 1.0;
  return wv;
}

// utils/graphics_utils.py getProjectionMatrix: z in [0,1], +z forward
Mat4 projection(double znear, double zfar, double fovx, double fovy) {
  Mat4 p;
  p.m[0][0] = 1.0 / std::tan(fovx / 2);
  p.m[1][1] = 1.0 / std::tan(fovy / 2);
  p.m[2][2] = zfar / (zfar - znear);
  p.m[2][3] = -(zfar * znear) / (zfar - znear);
  p.m[3][2] = 1.0;
  return p;
}

// GL wire layout: transpose, then negate the listed columns
void wire_flatten(const Mat4 &a, const int *neg_cols, int n_neg,
                  double out[16]) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double v = a.m[j][i];  // transpose
      for (int k = 0; k < n_neg; ++k)
        if (j == neg_cols[k]) v = -v;  // column j of the transposed matrix
      out[i * 4 + j] = v;
    }
}

bool send_all(int fd, const void *buf, size_t n) {
  const char *p = static_cast<const char *>(buf);
  while (n) {
    ssize_t w = ::send(fd, p, n, 0);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void *buf, size_t n) {
  char *p = static_cast<char *>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

std::string json_floats(const double *v, int n) {
  std::string s = "[";
  char tmp[48];
  for (int i = 0; i < n; ++i) {
    std::snprintf(tmp, sizeof(tmp), "%.17g%s", v[i], i + 1 < n ? "," : "");
    s += tmp;
  }
  return s + "]";
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s <host> <port> <width> <height> [frames=8] "
                 "[out_prefix=frame] [scaling=1.0] [radius=3.5]\n",
                 argv[0]);
    return 2;
  }
  const char *host = argv[1];
  int port = std::atoi(argv[2]);
  int width = std::atoi(argv[3]);
  int height = std::atoi(argv[4]);
  int frames = argc > 5 ? std::atoi(argv[5]) : 8;
  std::string prefix = argc > 6 ? argv[6] : "frame";
  double scaling = argc > 7 ? std::atof(argv[7]) : 1.0;
  double radius = argc > 8 ? std::atof(argv[8]) : 3.5;

  addrinfo hints = {}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  std::snprintf(portstr, sizeof(portstr), "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) {
    std::fprintf(stderr, "sibr_client: cannot resolve %s\n", host);
    return 1;
  }
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    std::fprintf(stderr, "sibr_client: connect %s:%d failed\n", host, port);
    return 1;
  }
  freeaddrinfo(res);

  double fovy = 2 * std::atan(std::tan(0.7) * height / width);
  double fovx = 1.4;
  Mat4 proj = projection(0.01, 100.0, fovx, fovy);
  std::vector<uint8_t> img(static_cast<size_t>(width) * height * 3);

  for (int f = 0; f < frames; ++f) {
    double ang = 2 * M_PI * f / std::max(frames, 1);
    double pos[3] = {radius * std::sin(ang), 0.4 * std::sin(3 * ang),
                     -radius * std::cos(ang)};
    Mat4 wv = look_at_origin(pos);
    Mat4 full = matmul(proj, wv);
    double vm[16], vpm[16];
    const int yz[2] = {1, 2}, y[1] = {1};
    wire_flatten(wv, yz, 2, vm);
    wire_flatten(full, y, 1, vpm);

    char head[512];
    std::snprintf(head, sizeof(head),
                  "{\"resolution_x\":%d,\"resolution_y\":%d,\"train\":true,"
                  "\"fov_y\":%.17g,\"fov_x\":%.17g,\"z_near\":0.01,"
                  "\"z_far\":100.0,\"shs_python\":false,"
                  "\"rot_scale_python\":false,\"keep_alive\":true,"
                  "\"scaling_modifier\":%.17g,\"view_matrix\":",
                  width, height, fovy, fovx, scaling);
    std::string msg = std::string(head) + json_floats(vm, 16) +
                      ",\"view_projection_matrix\":" + json_floats(vpm, 16) +
                      "}";
    uint32_t len = static_cast<uint32_t>(msg.size());
    if (!send_all(fd, &len, 4) || !send_all(fd, msg.data(), msg.size())) {
      std::fprintf(stderr, "sibr_client: send failed\n");
      return 1;
    }
    if (!recv_all(fd, img.data(), img.size())) {
      std::fprintf(stderr, "sibr_client: frame recv failed\n");
      return 1;
    }
    uint32_t vlen = 0;
    if (!recv_all(fd, &vlen, 4) || vlen > (1u << 20)) {
      std::fprintf(stderr, "sibr_client: verify recv failed\n");
      return 1;
    }
    std::string verify(vlen, '\0');
    if (!recv_all(fd, verify.data(), vlen)) return 1;

    char name[512];
    std::snprintf(name, sizeof(name), "%s_%03d.ppm", prefix.c_str(), f);
    FILE *out = std::fopen(name, "wb");
    if (!out) {
      std::fprintf(stderr, "sibr_client: cannot write %s\n", name);
      return 1;
    }
    std::fprintf(out, "P6\n%d %d\n255\n", width, height);
    std::fwrite(img.data(), 1, img.size(), out);
    std::fclose(out);
    std::printf("frame %d <- %s (scene: %s)\n", f, name, verify.c_str());
    std::fflush(stdout);
  }
  ::close(fd);
  return 0;
}
