/*
 * Huffman entropy decoding of one baseline (sequential, 8-bit) JPEG scan
 * into quantised DCT coefficient blocks.
 *
 * This is the only part of the port's JPEG decoder (data/jpeg.py) that is
 * not numpy: it is sequential bit by bit. It follows ITU-T T.81 Annex F
 * (F.2.2: DECODE, RECEIVE, EXTEND) and reads the entropy-coded segment as
 * libjpeg's jdhuff.c does: byte stuffing (FF 00 is a data byte FF), runs of
 * fill bytes FF before a marker, restart markers RST0-7 after every
 * `restart_interval` MCUs with the DC predictors reset there. Where libjpeg
 * would insert zero bits after a marker and warn, this decoder returns an
 * error code and the byte offset, and data/jpeg.py raises.
 *
 * Plain C99, no library: compiled with the host C compiler into a shared
 * library at first use and called through ctypes.
 */

#include <stdint.h>
#include <string.h>

enum {
  JPEG_OK = 0,
  JPEG_ERR_TRUNCATED = 1,    /* a marker or the end of the data inside an MCU */
  JPEG_ERR_BAD_CODE = 2,     /* a bit pattern that is no Huffman code */
  JPEG_ERR_RESTART = 3,      /* the expected RSTn marker is missing */
  JPEG_ERR_AC_OVERFLOW = 4,  /* an AC run past coefficient 63 */
  JPEG_ERR_TABLE = 5,        /* a Huffman table with too many codes */
  JPEG_ERR_LAYOUT = 6,       /* an MCU outside the caller's block arrays */
};

/* Zigzag position -> natural (row-major) position in the 8x8 block. */
static const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

#define LOOKAHEAD 9

typedef struct {
  int32_t maxcode[18];   /* largest code of each length, -1 if none */
  int32_t valoffset[18]; /* index into huffval of a code of each length */
  uint8_t huffval[256];
  /* The first LOOKAHEAD bits -> (code length << 8) | symbol; 0 if longer. */
  uint16_t look[1 << LOOKAHEAD];
} HuffTable;

typedef struct {
  const uint8_t *data;
  int64_t len;
  int64_t pos;      /* next byte to read; never moves past a marker */
  uint64_t buf;     /* bits, the oldest at the top of the low `bits` */
  int bits;         /* valid bits in buf */
  int fake;         /* zero bits appended at a marker (the newest `fake` bits) */
} BitReader;

/* Build the decode tables from the DHT's 16 code counts and its symbols
 * (the canonical code of T.81 Annex C). */
static int build_table(const uint8_t *counts, const uint8_t *symbols, HuffTable *t) {
  int32_t code = 0, k = 0;
  int total = 0;
  for (int l = 0; l < 16; l++) total += counts[l];
  if (total > 256) return JPEG_ERR_TABLE;
  memcpy(t->huffval, symbols, (size_t)total);
  memset(t->look, 0, sizeof(t->look));
  for (int l = 1; l <= 16; l++) {
    int n = counts[l - 1];
    if (n) {
      t->valoffset[l] = k - code;
      for (int i = 0; i < n; i++, k++, code++) {
        if (l <= LOOKAHEAD) {
          int shift = LOOKAHEAD - l;
          for (int j = 0; j < (1 << shift); j++)
            t->look[(code << shift) | j] = (uint16_t)((l << 8) | t->huffval[k]);
        }
      }
      t->maxcode[l] = code - 1;
      if (code - 1 >= (1 << l)) return JPEG_ERR_TABLE;
    } else {
      t->maxcode[l] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;  /* sentinel: no code is longer than 16 */
  return JPEG_OK;
}

/* Top the buffer up to at least 25 bits. At a marker (FF followed by a byte
 * other than 00; runs of FF are fill) no byte is consumed: zero bits are
 * appended and counted as fake, as libjpeg appends them. */
static void fill(BitReader *r) {
  while (r->bits <= 56) {
    int byte = -1;
    if (r->pos < r->len) {
      int c = r->data[r->pos];
      if (c != 0xFF) {
        byte = c;
        r->pos++;
      } else {
        int64_t q = r->pos + 1;
        while (q < r->len && r->data[q] == 0xFF) q++;
        if (q < r->len && r->data[q] == 0x00) {
          byte = 0xFF;
          r->pos = q + 1;
        } else {
          r->pos = q - 1;  /* stay on the marker's last FF */
        }
      }
    }
    if (byte < 0) {
      if (r->bits >= 25) return;
      r->buf <<= 8;
      r->bits += 8;
      r->fake += 8;
      continue;
    }
    r->buf = (r->buf << 8) | (uint64_t)byte;
    r->bits += 8;
  }
}

static inline int peek(BitReader *r, int n) {
  if (r->bits < n) fill(r);
  return (int)((r->buf >> (r->bits - n)) & ((1u << n) - 1));
}

/* Consume n bits; reading into the appended zeros is truncated data. */
static inline int skip(BitReader *r, int n) {
  r->bits -= n;
  if (r->bits < r->fake) return JPEG_ERR_TRUNCATED;
  return JPEG_OK;
}

static inline int get_bits(BitReader *r, int n, int *out) {
  if (n == 0) {
    *out = 0;
    return JPEG_OK;
  }
  *out = peek(r, n);
  return skip(r, n);
}

static int decode_symbol(BitReader *r, const HuffTable *t, int *sym) {
  int look = peek(r, LOOKAHEAD);
  int entry = t->look[look];
  if (entry) {
    *sym = entry & 0xFF;
    return skip(r, entry >> 8);
  }
  int code = peek(r, 16);
  for (int l = LOOKAHEAD + 1; l <= 16; l++) {
    int c = code >> (16 - l);
    if (c <= t->maxcode[l]) {
      *sym = t->huffval[t->valoffset[l] + c];
      return skip(r, l);
    }
  }
  return JPEG_ERR_BAD_CODE;
}

/* EXTEND of T.81 F.2.2.1: s magnitude bits -> the signed value. */
static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static int decode_block(BitReader *r, const HuffTable *dc, const HuffTable *ac, int *pred,
                        int16_t *block) {
  int s, v, err;
  if ((err = decode_symbol(r, dc, &s))) return err;
  if (s > 15) return JPEG_ERR_BAD_CODE;
  if ((err = get_bits(r, s, &v))) return err;
  *pred += s ? extend(v, s) : 0;
  block[0] = (int16_t)*pred;
  for (int k = 1; k < 64; k++) {
    int rs;
    if ((err = decode_symbol(r, ac, &rs))) return err;
    int run = rs >> 4;
    s = rs & 15;
    if (s == 0) {
      if (run != 15) break;  /* EOB */
      k += 15;               /* ZRL: sixteen zeros */
      if (k > 63) return JPEG_ERR_AC_OVERFLOW;
      continue;
    }
    k += run;
    if (k > 63) return JPEG_ERR_AC_OVERFLOW;
    if ((err = get_bits(r, s, &v))) return err;
    block[kNatural[k]] = (int16_t)extend(v, s);
  }
  return JPEG_OK;
}

/* Expect RST(expected) at the reader's byte position (after any fill FF
 * bytes) and step past it; the bit buffer is emptied. */
static int read_restart(BitReader *r, int expected) {
  int64_t p = r->pos;
  if (p >= r->len || r->data[p] != 0xFF) return JPEG_ERR_RESTART;
  while (p < r->len && r->data[p] == 0xFF) p++;
  if (p >= r->len || r->data[p] != 0xD0 + expected) return JPEG_ERR_RESTART;
  r->pos = p + 1;
  r->buf = 0;
  r->bits = 0;
  r->fake = 0;
  return JPEG_OK;
}

/*
 * Decode one scan.
 *
 *   data, len, start: the file's bytes and the offset of the first byte
 *     after the SOS segment.
 *   ncomp: components in the scan (1-4); for each of them, in scan order:
 *     h[i], v[i]: its sampling factors (blocks per MCU when interleaved),
 *     blocks[i]: its int16 coefficient array [rows][cols][64], zeroed by
 *       the caller, written in natural order,
 *     rows[i], cols[i]: that array's block rows and columns,
 *     used_rows[i], used_cols[i]: the blocks a non-interleaved scan codes
 *       (ceil of the component's size / 8),
 *     dc_counts[i] / dc_symbols[i], ac_counts[i] / ac_symbols[i]: its
 *       tables, as the DHT segment gives them (16 counts, the symbols).
 *   mcus_x, mcus_y: MCUs across and down when interleaved.
 *   restart_interval: MCUs between restart markers, 0 for none.
 *   end: out, the offset where the scan's data ended (at the next marker
 *     on success, the failing byte on error).
 *
 * Returns JPEG_OK or an error code.
 */
int nrc_jpeg_decode_scan(const uint8_t *data, int64_t len, int64_t start, int ncomp,
                         const int32_t *h, const int32_t *v, int16_t **blocks,
                         const int32_t *rows, const int32_t *cols, const int32_t *used_rows,
                         const int32_t *used_cols, const uint8_t **dc_counts,
                         const uint8_t **dc_symbols, const uint8_t **ac_counts,
                         const uint8_t **ac_symbols, int32_t mcus_x, int32_t mcus_y,
                         int32_t restart_interval, int64_t *end) {
  HuffTable dc[4], ac[4];
  int pred[4] = {0, 0, 0, 0};
  int err;
  BitReader r = {data, len, start, 0, 0, 0};
  *end = start;
  if (ncomp < 1 || ncomp > 4) return JPEG_ERR_LAYOUT;
  for (int i = 0; i < ncomp; i++) {
    if ((err = build_table(dc_counts[i], dc_symbols[i], &dc[i]))) return err;
    if ((err = build_table(ac_counts[i], ac_symbols[i], &ac[i]))) return err;
  }
  int64_t total;
  int32_t per_row;
  if (ncomp == 1) {
    per_row = used_cols[0];
    total = (int64_t)used_rows[0] * used_cols[0];
  } else {
    per_row = mcus_x;
    total = (int64_t)mcus_x * mcus_y;
  }
  int next_rst = 0;
  for (int64_t m = 0; m < total; m++) {
    if (restart_interval && m > 0 && m % restart_interval == 0) {
      if ((err = read_restart(&r, next_rst))) {
        *end = r.pos;
        return err;
      }
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < ncomp; i++) pred[i] = 0;
    }
    int64_t my = m / per_row, mx = m % per_row;
    for (int i = 0; i < ncomp; i++) {
      int bh = ncomp == 1 ? 1 : v[i], bw = ncomp == 1 ? 1 : h[i];
      for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bw; bx++) {
          int64_t row = my * bh + by, col = mx * bw + bx;
          int16_t *block = blocks[i] + ((row * cols[i] + col) * 64);
          if (row >= rows[i] || col >= cols[i]) return JPEG_ERR_LAYOUT;
          if ((err = decode_block(&r, &dc[i], &ac[i], &pred[i], block))) {
            *end = r.pos;
            return err;
          }
        }
      }
    }
  }
  *end = r.pos;
  return JPEG_OK;
}
