// detex_tpu native host library.
//
// The reference framework is pure Python (SURVEY.md section 0: no native
// components exist upstream); detex_tpu adds a small C++ core for the
// host-side data-prep path that feeds the device: second-order-section IIR
// filtering (obspy-style zero-phase: forward pass then reversed pass, no
// padding), linear detrending, channel interleaving (multiplexing), and a
// fused prep kernel that does detrend -> bandpass -> interleave in one call
// per chunk. Exposed via a plain C ABI for ctypes.
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SOS filtering (direct form II transposed), matching scipy.signal.sosfilt.
// sos: [nsec][6] = {b0, b1, b2, a0, a1, a2} with a0 == 1.
// ---------------------------------------------------------------------------
static void sosfilt_inplace(const double* sos, int nsec, double* x,
                            int64_t n) {
    std::vector<double> z(2 * nsec, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        double v = x[i];
        for (int s = 0; s < nsec; ++s) {
            const double* c = sos + 6 * s;
            double* zs = z.data() + 2 * s;
            double out = c[0] * v + zs[0];
            zs[0] = c[1] * v - c[4] * out + zs[1];
            zs[1] = c[2] * v - c[5] * out;
            v = out;
        }
        x[i] = v;
    }
}

void detex_sosfilt(const double* sos, int nsec, double* x, int64_t n,
                   int zerophase) {
    sosfilt_inplace(sos, nsec, x, n);
    if (zerophase) {
        // obspy semantics: filter the reversed signal and reverse back
        for (int64_t i = 0, j = n - 1; i < j; ++i, --j) {
            double t = x[i];
            x[i] = x[j];
            x[j] = t;
        }
        sosfilt_inplace(sos, nsec, x, n);
        for (int64_t i = 0, j = n - 1; i < j; ++i, --j) {
            double t = x[i];
            x[i] = x[j];
            x[j] = t;
        }
    }
}

// ---------------------------------------------------------------------------
// Linear detrend (least-squares line removal), matching
// scipy.signal.detrend(type='linear').
// ---------------------------------------------------------------------------
void detex_detrend_linear(double* x, int64_t n) {
    if (n < 2) return;
    // fit y = a + b * t with t = 0..n-1 via closed-form least squares
    const double nn = static_cast<double>(n);
    const double st = (nn - 1.0) * nn / 2.0;             // sum t
    const double stt = (nn - 1.0) * nn * (2.0 * nn - 1.0) / 6.0;  // sum t^2
    double sy = 0.0, sty = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        sy += x[i];
        sty += x[i] * static_cast<double>(i);
    }
    const double det = nn * stt - st * st;
    const double b = (nn * sty - st * sy) / det;
    const double a = (sy - b * st) / nn;
    for (int64_t i = 0; i < n; ++i) {
        x[i] -= a + b * static_cast<double>(i);
    }
}

// ---------------------------------------------------------------------------
// Channel interleave: chans [nc][n] (contiguous row-major) ->
// out [n * nc] multiplexed (Fortran-order flatten of the [nc, n] stack,
// reference construct.py:978).
// ---------------------------------------------------------------------------
void detex_interleave(const double* chans, int nc, int64_t n, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t base = i * nc;
        for (int c = 0; c < nc; ++c) {
            out[base + c] = chans[static_cast<int64_t>(c) * n + i];
        }
    }
}

// ---------------------------------------------------------------------------
// Fused chunk prep: for each channel detrend + (zero-phase) bandpass, then
// interleave. chans is modified in place (filtered), out receives the
// multiplexed vector. Returns 0 on success.
// ---------------------------------------------------------------------------
int detex_prep_chunk(double* chans, int nc, int64_t n, const double* sos,
                     int nsec, int zerophase, double* out) {
    for (int c = 0; c < nc; ++c) {
        double* ch = chans + static_cast<int64_t>(c) * n;
        detex_detrend_linear(ch, n);
        if (nsec > 0) {
            detex_sosfilt(sos, nsec, ch, n, zerophase);
        }
    }
    detex_interleave(chans, nc, n, out);
    return 0;
}

// rolling sample std (ddof=1) used by magnitude SNR estimation
// (reference detect.py:465-472); out has length n - win + 1.
void detex_rolling_std(const double* x, int64_t n, int64_t win,
                       double* out) {
    if (win > n || win < 2) return;
    double s = 0.0, s2 = 0.0;
    for (int64_t i = 0; i < win; ++i) {
        s += x[i];
        s2 += x[i] * x[i];
    }
    const double w = static_cast<double>(win);
    out[0] = std::sqrt(std::fmax((s2 - s * s / w) / (w - 1.0), 0.0));
    for (int64_t i = win; i < n; ++i) {
        s += x[i] - x[i - win];
        s2 += x[i] * x[i] - x[i - win] * x[i - win];
        out[i - win + 1] =
            std::sqrt(std::fmax((s2 - s * s / w) / (w - 1.0), 0.0));
    }
}


// ---------------------------------------------------------------------------
// miniSEED v2 record codec (capability of the reference's obspy-backed
// waveform IO, getdata.py: the reference reads/writes event and continuous
// archives as miniSEED). Native so the framework is standalone: fixed
// header + blockette-1000 parsing, STEIM1/STEIM2/INT16/INT32/FLOAT32/
// FLOAT64 decoding, STEIM1 encoding. Big- and little-endian records
// (byte order detected from the year field). No blockette-100 rate
// override, no ASCII/legacy encodings.
// ---------------------------------------------------------------------------

static uint16_t rd_u16(const uint8_t* p, int swap) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    if (swap) v = static_cast<uint16_t>((v >> 8) | (v << 8));
    return v;
}

static uint32_t rd_u32(const uint8_t* p, int swap) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    if (swap) v = __builtin_bswap32(v);
    return v;
}

static int host_is_little() {
    const uint16_t one = 1;
    return *reinterpret_cast<const uint8_t*>(&one) == 1;
}

// days since 1970-01-01 for Jan 1 of `year` (Hinnant's civil algorithm)
static int64_t days_to_year(int64_t y) {
    y -= 1;  // days to Dec 31 of previous year
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const int64_t yoe = y - era * 400;
    const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + yoe / 400;
    return era * 146097 + doe - 719162;  // days from 1970-01-01 to Jan 1
}

static void put_field(char* dst, const uint8_t* src, int len) {
    int k = 0;
    for (int i = 0; i < len; ++i) {
        char c = static_cast<char>(src[i]);
        if (c != ' ' && c != '\0') dst[k++] = c;
    }
    dst[k] = '\0';
}

// decode STEIM1/2 frames; returns samples decoded or -1
static int steim_decode(const uint8_t* p, int64_t nbytes, int nsamp,
                        int steim2, int swap, double* out, int64_t cap) {
    if (nsamp <= 0) return 0;
    const int64_t nframes = nbytes / 64;
    int32_t x0 = 0;
    int have_x0 = 0;
    int64_t k = 0;           // diffs seen (first diff is discarded)
    int32_t cur = 0;
    for (int64_t f = 0; f < nframes && k < nsamp; ++f) {
        const uint8_t* fr = p + f * 64;
        const uint32_t w0 = rd_u32(fr, swap);
        for (int w = 1; w < 16 && k < nsamp; ++w) {
            const int c = (w0 >> (2 * (15 - w))) & 3;
            const uint32_t word = rd_u32(fr + 4 * w, swap);
            if (f == 0 && w == 1) {        // forward integration constant
                x0 = static_cast<int32_t>(word);
                have_x0 = 1;
                continue;
            }
            if (f == 0 && w == 2) continue;  // reverse constant (unused)
            if (c == 0) continue;
            int32_t d[7];
            int cnt = 0;
            if (c == 1) {                   // 4 x 8-bit (both variants)
                cnt = 4;
                for (int j = 0; j < 4; ++j)
                    d[j] = static_cast<int32_t>(word << (8 * j)) >> 24;
            } else if (!steim2) {
                if (c == 2) {               // 2 x 16-bit
                    cnt = 2;
                    for (int j = 0; j < 2; ++j)
                        d[j] = static_cast<int32_t>(word << (16 * j)) >> 16;
                } else {                    // 1 x 32-bit
                    cnt = 1;
                    d[0] = static_cast<int32_t>(word);
                }
            } else {
                const int dnib = (word >> 30) & 3;
                int bits = 0;
                if (c == 2) {
                    if (dnib == 1) { cnt = 1; bits = 30; }
                    else if (dnib == 2) { cnt = 2; bits = 15; }
                    else if (dnib == 3) { cnt = 3; bits = 10; }
                    else return -1;
                } else {                    // c == 3
                    if (dnib == 0) { cnt = 5; bits = 6; }
                    else if (dnib == 1) { cnt = 6; bits = 5; }
                    else if (dnib == 2) { cnt = 7; bits = 4; }
                    else return -1;
                }
                for (int j = 0; j < cnt; ++j)
                    d[j] = static_cast<int32_t>(
                        word << (32 - bits * (cnt - j))) >> (32 - bits);
            }
            for (int j = 0; j < cnt && k < nsamp; ++j) {
                if (k == 0) {
                    if (!have_x0) return -1;
                    cur = x0;               // first diff discarded
                } else {
                    // mod-2^32 wrap via unsigned add (signed overflow is
                    // UB; encoders rely on the wrap for extreme diffs)
                    cur = static_cast<int32_t>(static_cast<uint32_t>(cur) +
                                               static_cast<uint32_t>(d[j]));
                }
                if (k >= cap) return -1;
                out[k++] = static_cast<double>(cur);
            }
        }
    }
    return static_cast<int>(k);
}

// Parse + decode ONE miniSEED v2 record.
// Returns record length in bytes, or -1 bad header, -2 unsupported
// encoding / missing blockette 1000, -3 capacity, -4 decode error.
// id24 <- "NET.STA.LOC.CHAN" (loc may be empty); t0 epoch seconds;
// sr Hz; nsamp_out samples written to out.
int detex_mseed_record(const uint8_t* buf, int64_t buflen, char* id24,
                       double* t0, double* sr, int32_t* nsamp_out,
                       double* out, int64_t cap) {
    if (buflen < 64) return -1;
    // sequence number must be digits/spaces, quality D/R/Q/M
    for (int i = 0; i < 6; ++i)
        if (!((buf[i] >= '0' && buf[i] <= '9') || buf[i] == ' '))
            return -1;
    const char q = static_cast<char>(buf[6]);
    if (q != 'D' && q != 'R' && q != 'Q' && q != 'M') return -1;
    // byte order from the year field
    int swap = 0;
    uint16_t year = rd_u16(buf + 20, 0);
    if (year < 1900 || year > 2100) {
        swap = 1;
        year = rd_u16(buf + 20, 1);
        if (year < 1900 || year > 2100) return -1;
    }
    // file stores big-endian when the non-swapped read works on a BE host;
    // `swap` already expresses "swap relative to host", which is all we
    // need for every further field.
    const uint16_t doy = rd_u16(buf + 22, swap);
    const int hour = buf[24], minute = buf[25], sec = buf[26];
    const uint16_t fract = rd_u16(buf + 28, swap);
    const uint16_t nsamp = rd_u16(buf + 30, swap);
    const int16_t rfac =
        static_cast<int16_t>(rd_u16(buf + 32, swap));
    const int16_t rmul =
        static_cast<int16_t>(rd_u16(buf + 34, swap));
    const uint8_t act = buf[36];
    const int32_t tcorr = static_cast<int32_t>(rd_u32(buf + 40, swap));
    const uint16_t data_off = rd_u16(buf + 44, swap);
    uint16_t boff = rd_u16(buf + 46, swap);
    // id
    char net[4], sta[8], loc[4], chan[8];
    put_field(net, buf + 18, 2);
    put_field(sta, buf + 8, 5);
    put_field(loc, buf + 13, 2);
    put_field(chan, buf + 15, 3);
    std::snprintf(id24, 24, "%s.%s.%s.%s", net, sta, loc, chan);
    // time
    double t = static_cast<double>(days_to_year(year) + (doy - 1)) * 86400.0
        + hour * 3600.0 + minute * 60.0 + sec + fract * 1e-4;
    if (!(act & 0x02)) t += tcorr * 1e-4;   // unapplied time correction
    *t0 = t;
    // rate
    double rate = 0.0;
    if (rfac > 0) rate = rfac;
    else if (rfac < 0) rate = -1.0 / rfac;
    if (rmul > 0) rate *= rmul;
    else if (rmul < 0) rate /= -rmul;
    *sr = rate;
    // blockette walk for 1000
    int enc = -1, reclen = 0;
    int guard = 0;
    while (boff >= 48 && boff + 4 <= buflen && guard++ < 16) {
        const uint16_t btype = rd_u16(buf + boff, swap);
        const uint16_t bnext = rd_u16(buf + boff + 2, swap);
        if (btype == 1000 && boff + 7 <= buflen) {
            enc = buf[boff + 4];
            const uint8_t rl = buf[boff + 6];
            if (rl < 6 || rl > 24) return -2;  // corrupt length exponent
            reclen = 1 << rl;
            break;
        }
        if (bnext <= boff) break;
        boff = bnext;
    }
    if (enc < 0 || reclen < 64 || reclen > buflen) return -2;
    if (data_off < 48 || data_off >= reclen) return -1;
    if (nsamp > cap) return -3;
    // unsupported encodings (ASCII/LOG records, legacy codecs): the
    // record length is known, so report it with nsamp_out = -2 and let
    // the reader skip instead of aborting the whole file
    if (enc != 1 && enc != 3 && enc != 4 && enc != 5 && enc != 10 &&
        enc != 11) {
        *nsamp_out = -2;
        return reclen;
    }
    const uint8_t* p = buf + data_off;
    const int64_t nbytes = reclen - data_off;
    int got = 0;
    switch (enc) {
        case 1:   // INT16
            if (nbytes < 2 * nsamp) return -4;
            for (int i = 0; i < nsamp; ++i)
                out[i] = static_cast<int16_t>(rd_u16(p + 2 * i, swap));
            got = nsamp;
            break;
        case 3:   // INT32
            if (nbytes < 4 * nsamp) return -4;
            for (int i = 0; i < nsamp; ++i)
                out[i] = static_cast<int32_t>(rd_u32(p + 4 * i, swap));
            got = nsamp;
            break;
        case 4: { // FLOAT32
            if (nbytes < 4 * nsamp) return -4;
            for (int i = 0; i < nsamp; ++i) {
                const uint32_t v = rd_u32(p + 4 * i, swap);
                float f;
                std::memcpy(&f, &v, 4);
                out[i] = f;
            }
            got = nsamp;
            break;
        }
        case 5: { // FLOAT64
            if (nbytes < 8 * nsamp) return -4;
            for (int i = 0; i < nsamp; ++i) {
                uint64_t v;
                std::memcpy(&v, p + 8 * i, 8);
                if (swap) v = __builtin_bswap64(v);
                double f;
                std::memcpy(&f, &v, 8);
                out[i] = f;
            }
            got = nsamp;
            break;
        }
        case 10:  // STEIM1
        case 11:  // STEIM2
            got = steim_decode(p, nbytes, nsamp, enc == 11, swap, out,
                               cap);
            break;
        default:
            return -2;
    }
    if (got != nsamp) {           // corrupt payload: skippable
        *nsamp_out = -4;
        return reclen;
    }
    *nsamp_out = nsamp;
    return reclen;
}

// STEIM1-encode int32 samples into big-endian 64-byte frames.
// Packs greedily (4x8 / 2x16 / 1x32 bit diffs); frame 0 words 1-2 hold
// the forward/reverse integration constants. Returns samples consumed
// (<= n), limited by nframes capacity.
int detex_steim1_encode(const int32_t* x, int64_t n, uint8_t* out,
                        int nframes) {
    if (n <= 0 || nframes <= 0) return 0;
    const int need_swap = host_is_little();
    std::memset(out, 0, static_cast<size_t>(nframes) * 64);
    int64_t k = 0;          // samples consumed
    int32_t prev = x[0];    // first diff = 0
    auto put_word = [&](int f, int w, uint32_t v) {
        uint32_t be = need_swap ? __builtin_bswap32(v) : v;
        std::memcpy(out + f * 64 + 4 * w, &be, 4);
    };
    auto diff_at = [&](int64_t i) -> int64_t {
        return i == 0 ? 0
                      : static_cast<int64_t>(x[i]) -
                            static_cast<int64_t>(x[i - 1]);
    };
    for (int f = 0; f < nframes && k < n; ++f) {
        uint32_t w0 = 0;
        const int wstart = (f == 0) ? 3 : 1;
        for (int w = wstart; w < 16 && k < n; ++w) {
            // how many upcoming diffs fit 8/16 bits?
            int64_t d0 = diff_at(k);
            int c;
            uint32_t word;
            auto fits = [&](int64_t v, int bits) {
                const int64_t lim = int64_t(1) << (bits - 1);
                return v >= -lim && v < lim;
            };
            if (k + 3 < n && fits(d0, 8) && fits(diff_at(k + 1), 8) &&
                fits(diff_at(k + 2), 8) && fits(diff_at(k + 3), 8)) {
                c = 1;
                word = 0;
                for (int j = 0; j < 4; ++j)
                    word = (word << 8) |
                           (static_cast<uint32_t>(diff_at(k + j)) & 0xffu);
                k += 4;
            } else if (k + 1 < n && fits(d0, 16) &&
                       fits(diff_at(k + 1), 16)) {
                c = 2;
                word = (static_cast<uint32_t>(diff_at(k)) & 0xffffu) << 16;
                word |= static_cast<uint32_t>(diff_at(k + 1)) & 0xffffu;
                k += 2;
            } else {
                c = 3;
                word = static_cast<uint32_t>(diff_at(k));
                k += 1;
            }
            w0 |= static_cast<uint32_t>(c) << (2 * (15 - w));
            put_word(f, w, word);
        }
        put_word(f, 0, w0);
    }
    // integration constants: first sample, last encoded sample
    put_word(0, 1, static_cast<uint32_t>(x[0]));
    put_word(0, 2, static_cast<uint32_t>(x[k - 1]));
    (void)prev;
    return static_cast<int>(k);
}

// STEIM2-encode int32 samples into big-endian 64-byte frames.
// Greedy densest-class packing per 32-bit word: 7x4 / 6x5 / 5x6 bits
// (c=3, dnib 2/1/0), 4x8 (c=1, no dnib), 3x10 / 2x15 / 1x30 (c=2,
// dnib 3/2/1). Frame 0 words 1-2 hold the forward/reverse integration
// constants. Returns samples consumed (<= n, limited by capacity), or
// -1 if a sample-to-sample difference exceeds the 30-bit STEIM2 range.
int detex_steim2_encode(const int32_t* x, int64_t n, uint8_t* out,
                        int nframes) {
    if (n <= 0 || nframes <= 0) return 0;
    const int need_swap = host_is_little();
    std::memset(out, 0, static_cast<size_t>(nframes) * 64);
    int64_t k = 0;
    auto put_word = [&](int f, int w, uint32_t v) {
        uint32_t be = need_swap ? __builtin_bswap32(v) : v;
        std::memcpy(out + f * 64 + 4 * w, &be, 4);
    };
    auto diff_at = [&](int64_t i) -> int64_t {
        return i == 0 ? 0
                      : static_cast<int64_t>(x[i]) -
                            static_cast<int64_t>(x[i - 1]);
    };
    auto fits = [&](int64_t v, int bits) {
        const int64_t lim = int64_t(1) << (bits - 1);
        return v >= -lim && v < lim;
    };
    auto run_fits = [&](int cnt, int bits) {
        if (k + cnt > n) return false;
        for (int j = 0; j < cnt; ++j)
            if (!fits(diff_at(k + j), bits)) return false;
        return true;
    };
    for (int f = 0; f < nframes && k < n; ++f) {
        uint32_t w0 = 0;
        const int wstart = (f == 0) ? 3 : 1;
        for (int w = wstart; w < 16 && k < n; ++w) {
            int c, cnt, bits, dnib;
            if (run_fits(7, 4)) {
                c = 3; dnib = 2; cnt = 7; bits = 4;
            } else if (run_fits(6, 5)) {
                c = 3; dnib = 1; cnt = 6; bits = 5;
            } else if (run_fits(5, 6)) {
                c = 3; dnib = 0; cnt = 5; bits = 6;
            } else if (run_fits(4, 8)) {
                c = 1; dnib = -1; cnt = 4; bits = 8;
            } else if (run_fits(3, 10)) {
                c = 2; dnib = 3; cnt = 3; bits = 10;
            } else if (run_fits(2, 15)) {
                c = 2; dnib = 2; cnt = 2; bits = 15;
            } else if (fits(diff_at(k), 30)) {
                c = 2; dnib = 1; cnt = 1; bits = 30;
            } else {
                return -1;  // diff exceeds STEIM2's 30-bit maximum
            }
            uint32_t word = (dnib >= 0)
                ? (static_cast<uint32_t>(dnib) << 30) : 0u;
            const uint32_t mask =
                (bits == 32) ? 0xffffffffu
                             : ((uint32_t(1) << bits) - 1u);
            for (int j = 0; j < cnt; ++j)
                word |= (static_cast<uint32_t>(diff_at(k + j)) & mask)
                        << (bits * (cnt - 1 - j));
            k += cnt;
            w0 |= static_cast<uint32_t>(c) << (2 * (15 - w));
            put_word(f, w, word);
        }
        put_word(f, 0, w0);
    }
    put_word(0, 1, static_cast<uint32_t>(x[0]));
    put_word(0, 2, static_cast<uint32_t>(x[k - 1]));
    return static_cast<int>(k);
}

int detex_abi_version() { return 3; }

}  // extern "C"
