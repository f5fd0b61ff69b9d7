// The JSON body of a motion reply, written by host code.
//
// motion_json writes exactly the bytes of Python's
//
//     json.dumps({"frames": int(frames), "motion": rows.tolist()}).encode()
//
// for a C-contiguous float32 (frames, width) array: each value widened to
// double (as tolist does) and laid out as repr(float), with json's default
// separators ", " and ": " and its NaN / Infinity / -Infinity. It reads only
// its arguments, so any number of threads may call it at once; bound with
// ctypes.CDLL, the call runs without the interpreter lock.
//
// repr(float) takes the shortest digit string that reads back as the same
// double (the nearest such string on a tie of length), here from
// std::to_chars, and with the decimal point after the first digit at
// position decpt (value = 0.d1d2... x 10^decpt) writes
//   - fixed notation when -4 < decpt <= 16, that is 1e-4 <= |x| < 1e16, with
//     ".0" after an integral value: 0.0001, 123.5, 1e15 as 1000000000000000.0;
//   - otherwise d.ddd, e, the exponent's sign and at least two of its digits:
//     1e-05, 1.5e+16, -1.401298464324817e-45;
//   - 0.0 and -0.0 for the zeros.
// A float32 needs at most 17 significant digits as a double and its exponent
// at most two digits, so a value takes at most 23 bytes: a sign, 17 digits,
// the point and e-XX, or a sign, "0.000" and 17 digits.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kValueMax = 23;

// Appends to a buffer of fixed capacity; a write that would not fit sets
// `full` and writes nothing more.
struct Out {
  char* p;
  char* end;
  bool full = false;

  void put(const char* s, size_t n) {
    if (full || n > size_t(end - p)) {
      full = true;
      return;
    }
    std::memcpy(p, s, n);
    p += n;
  }
  void put(const char* s) { put(s, std::strlen(s)); }
};

// repr(float(x)) as json.dumps writes it, into v (at least kValueMax bytes);
// returns the length.
int value_repr(double x, char* v) {
  if (std::isnan(x)) {
    std::memcpy(v, "NaN", 3);
    return 3;
  }
  if (std::isinf(x)) {
    if (x < 0) {
      std::memcpy(v, "-Infinity", 9);
      return 9;
    }
    std::memcpy(v, "Infinity", 8);
    return 8;
  }
  char* q = v;
  if (std::signbit(x)) *q++ = '-';
  if (x == 0) {
    std::memcpy(q, "0.0", 3);
    return int(q - v) + 3;
  }
  // Shortest round-trip digits in scientific form: d[.ddd]e(+|-)XX[X].
  char sci[32];
  const auto res = std::to_chars(sci, sci + sizeof sci, std::fabs(x),
                                 std::chars_format::scientific);
  char digits[20];
  int nd = 0;
  const char* s = sci;
  for (; *s != 'e'; ++s)
    if (*s != '.') digits[nd++] = *s;
  ++s;
  const bool neg_exp = *s == '-';
  int exp10 = 0;
  for (++s; s < res.ptr; ++s) exp10 = exp10 * 10 + (*s - '0');
  if (neg_exp) exp10 = -exp10;
  const int decpt = exp10 + 1;

  if (decpt > -4 && decpt <= 16) {
    if (decpt <= 0) {
      *q++ = '0';
      *q++ = '.';
      for (int i = 0; i < -decpt; ++i) *q++ = '0';
      std::memcpy(q, digits, nd);
      q += nd;
    } else if (decpt < nd) {
      std::memcpy(q, digits, decpt);
      q += decpt;
      *q++ = '.';
      std::memcpy(q, digits + decpt, nd - decpt);
      q += nd - decpt;
    } else {
      std::memcpy(q, digits, nd);
      q += nd;
      for (int i = nd; i < decpt; ++i) *q++ = '0';
      *q++ = '.';
      *q++ = '0';
    }
  } else {
    *q++ = digits[0];
    if (nd > 1) {
      *q++ = '.';
      std::memcpy(q, digits + 1, nd - 1);
      q += nd - 1;
    }
    *q++ = 'e';
    *q++ = exp10 < 0 ? '-' : '+';
    const int e = exp10 < 0 ? -exp10 : exp10;
    if (e >= 100) *q++ = char('0' + e / 100);
    *q++ = char('0' + e / 10 % 10);
    *q++ = char('0' + e % 10);
  }
  return int(q - v);
}

}  // namespace

extern "C" {

// The most bytes one value takes, for the caller's bound on the body.
int motion_json_value_max() { return kValueMax; }

// Writes the body for `rows`, a C-contiguous float32 (frames, width) array,
// into out[0, capacity). Returns the bytes written, or -1 when they would
// not fit (the buffer's content is then undefined).
int64_t motion_json(const float* rows, int64_t frames, int64_t width, char* out,
                    int64_t capacity) {
  if (frames < 0 || width < 0 || capacity < 0) return -1;
  Out o{out, out + capacity};
  char v[32];  // one value (kValueMax bytes at most) or the frame count (20)
  o.put("{\"frames\": ");
  const auto res = std::to_chars(v, v + sizeof v, frames);
  o.put(v, size_t(res.ptr - v));
  o.put(", \"motion\": [");
  for (int64_t f = 0; f < frames; ++f) {
    o.put(f ? ", [" : "[");
    const float* row = rows + f * width;
    for (int64_t i = 0; i < width; ++i) {
      if (i) o.put(", ", 2);
      o.put(v, size_t(value_repr(double(row[i]), v)));
    }
    o.put("]", 1);
    if (o.full) return -1;
  }
  o.put("]}", 2);
  return o.full ? -1 : int64_t(o.p - out);
}

}  // extern "C"
