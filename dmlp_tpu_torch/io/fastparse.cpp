// Native stdin-grammar parser of dmlp_tpu_torch: the port's own copy of
// the reference package's native/fastparse.cpp, reworked so that what it
// accepts, it parses exactly as the pure-Python parser
// (dmlp_tpu_torch/io/grammar.py) does, and everything else it rejects.
//
// The grammar: one header line "num_data num_queries num_attrs", num_data
// data lines "label a1 .. aA", num_queries query lines "Q k a1 .. aA";
// lines split on '\n' exactly, tokens on the ASCII whitespace Python's
// str.split() uses. Values go straight into caller-allocated flat arrays.
//
// Accepted: integers [+-]?[0-9]+ (labels and ks within int32), decimals
// [+-]?(digits[.digits*] | .digits)([eE][+-]?digits)?, both ending at
// whitespace or the end of the line; tokens past the A-th on a line are
// ignored, as the Python parser ignores them. Rejected: everything else,
// including what Python's float() alone would take (inf, nan) and every
// malformed line. A rejection returns nonzero with no message: the caller
// re-parses the payload with the Python parser, which raises the located
// ParseError (or, for the few tokens only it takes, returns the same
// arrays), so errors are the Python parser's by construction.
//
// Decimals convert with one correctly rounded step — the Clinger fast path
// (<= 15 significant digits, no exponent, an exact power of ten) or strtod
// under the "C" locale — which is what Python's float() gives.
//
// Build: g++ -O3 -shared -fPIC (dmlp_tpu_torch/io/native.py does it at
// first use into dmlp_tpu_torch/_build/ and loads it with ctypes).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {

locale_t c_locale() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return loc;
}

// Python's str.split() whitespace within a line (the ASCII part).
inline bool is_ws(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f' ||
           (c >= 0x1c && c <= 0x1f);
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// One line: [p, end) with end at its '\n' or the payload's end.
struct Line {
    const char* p;
    const char* end;
};

// Skip whitespace; false at the end of the line.
inline bool skip_ws(Line& ln) {
    while (ln.p < ln.end && is_ws(*ln.p)) ++ln.p;
    return ln.p < ln.end;
}

inline bool token_ends(const Line& ln, const char* q) {
    return q >= ln.end || is_ws(*q);
}

bool parse_int(Line& ln, long long lo, long long hi, long long* out) {
    if (!skip_ws(ln)) return false;
    const char* s = ln.p;
    bool neg = false;
    if (*s == '+' || *s == '-') {
        neg = *s == '-';
        ++s;
    }
    const char* d = s;
    long long v = 0;
    while (d < ln.end && is_digit(*d)) {
        if (d - s >= 18) return false;  // past long long: Python decides
        v = v * 10 + (*d - '0');
        ++d;
    }
    if (d == s || !token_ends(ln, d)) return false;
    v = neg ? -v : v;
    if (v < lo || v > hi) return false;
    ln.p = d;
    *out = v;
    return true;
}

static const double kPow10[23] = {
    1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11, 1e12,
    1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

bool parse_double(Line& ln, double* out, char* buf, size_t buflen) {
    if (!skip_ws(ln)) return false;
    const char* s = ln.p;
    const char* d = s;
    bool neg = false;
    if (*d == '+' || *d == '-') {
        neg = *d == '-';
        ++d;
    }
    uint64_t mant = 0;
    int digits = 0, frac = 0;
    while (d < ln.end && is_digit(*d)) {
        if (digits < 19) mant = mant * 10 + (uint64_t)(*d - '0');
        ++digits;
        ++d;
    }
    if (d < ln.end && *d == '.') {
        ++d;
        while (d < ln.end && is_digit(*d)) {
            if (digits < 19) {
                mant = mant * 10 + (uint64_t)(*d - '0');
                ++frac;
            }
            ++digits;
            ++d;
        }
    }
    if (digits == 0) return false;
    bool has_exp = false;
    if (d < ln.end && (*d == 'e' || *d == 'E')) {
        has_exp = true;
        ++d;
        if (d < ln.end && (*d == '+' || *d == '-')) ++d;
        const char* e = d;
        while (d < ln.end && is_digit(*d)) ++d;
        if (d == e) return false;
    }
    if (!token_ends(ln, d)) return false;
    if (digits <= 15 && frac <= 22 && !has_exp) {
        double v = (double)mant;
        if (frac) v /= kPow10[frac];
        *out = neg ? -v : v;
    } else {
        // strtod needs a terminated token: the payload is not one.
        size_t n = (size_t)(d - s);
        if (n + 1 > buflen) return false;
        memcpy(buf, s, n);
        buf[n] = '\0';
        *out = strtod_l(buf, nullptr, c_locale());
    }
    ln.p = d;
    return true;
}

// The line starting at *cur, advancing *cur past its '\n'; false when no
// line is left (the Python parser drops the empty string after a final
// '\n').
bool next_line(const char** cur, const char* end, Line* ln) {
    if (*cur >= end) return false;
    const char* nl = (const char*)memchr(*cur, '\n', (size_t)(end - *cur));
    ln->p = *cur;
    ln->end = nl ? nl : end;
    *cur = nl ? nl + 1 : end;
    return true;
}

bool has_underscore(const Line& ln) {
    return memchr(ln.p, '_', (size_t)(ln.end - ln.p)) != nullptr;
}

}  // namespace

extern "C" {

// Header and line count. out3 = (num_data, num_queries, num_attrs).
// Returns 0 when the payload is ASCII, the header's first three tokens are
// non-negative integers and at least 1 + num_data + num_queries lines
// follow; nonzero otherwise.
int dmlp_parse_header(const char* text, size_t len, long long* out3) {
    const char* end = text + len;
    for (const char* c = text; c < end; ++c)
        if ((unsigned char)*c >= 0x80) return 1;
    const char* cur = text;
    Line ln;
    if (!next_line(&cur, end, &ln)) return 1;
    for (int i = 0; i < 3; ++i)
        if (!parse_int(ln, 0, (1LL << 40), &out3[i])) return 1;
    long long lines = 1;
    for (const char* c = cur; c < end;) {
        const char* nl = (const char*)memchr(c, '\n', (size_t)(end - c));
        ++lines;
        c = nl ? nl + 1 : end;
    }
    return lines >= 1 + out3[0] + out3[1] ? 0 : 1;
}

// The records into caller-allocated arrays:
//   labels int32[num_data], data_attrs float64[num_data * num_attrs],
//   ks int32[num_queries], query_attrs float64[num_queries * num_attrs].
// Returns 0 on success, nonzero where the Python parser must decide.
int dmlp_parse_body(const char* text, size_t len, long long num_data,
                    long long num_queries, long long num_attrs,
                    int32_t* labels, double* data_attrs, int32_t* ks,
                    double* query_attrs) {
    const char* end = text + len;
    const char* cur = text;
    char buf[512];
    Line ln;
    long long v;
    if (!next_line(&cur, end, &ln)) return 1;  // the header
    for (long long i = 0; i < num_data; ++i) {
        if (!next_line(&cur, end, &ln) || ln.p == ln.end ||
            has_underscore(ln))
            return 2;
        if (!parse_int(ln, INT32_MIN, INT32_MAX, &v)) return 3;
        labels[i] = (int32_t)v;
        double* row = data_attrs + i * num_attrs;
        for (long long a = 0; a < num_attrs; ++a)
            if (!parse_double(ln, &row[a], buf, sizeof buf)) return 3;
    }
    for (long long i = 0; i < num_queries; ++i) {
        if (!next_line(&cur, end, &ln) || ln.p == ln.end || *ln.p != 'Q' ||
            has_underscore(ln))
            return 4;
        ++ln.p;
        if (!parse_int(ln, INT32_MIN, INT32_MAX, &v)) return 4;
        ks[i] = (int32_t)v;
        double* row = query_attrs + i * num_attrs;
        for (long long a = 0; a < num_attrs; ++a)
            if (!parse_double(ln, &row[a], buf, sizeof buf)) return 4;
    }
    return 0;
}

}  // extern "C"
