/*
 * Fast whitespace tokenizer + integer parser for genotype panel files.
 *
 * A copy of instruct_tpu/native/tokenize.c for the PyTorch/CUDA port (the
 * port loads its own build of it, never the JAX package's).  The
 * reference's data layer is native C (data_interface.c:36-880: two full
 * file scans, strtok-style splitting, per-token strcmp recodes).  This is
 * one pass over a memory buffer producing, for every token, either its
 * parsed integer value or a sentinel marking a non-integer token (names,
 * pop labels, alphanumeric alleles), plus per-line token counts.  Python
 * assembles the panel from the int grid and falls back to the pure-Python
 * path for any column containing sentinels.
 *
 * Built on the host at first use with `cc -O3 -shared -fPIC` and bound via
 * ctypes.  Host parsing only: no device code.
 */

#include <stdint.h>
#include <stddef.h>

#define NONINT INT64_MIN

/* Tokenize `buf[0..len)`.
 * Outputs:
 *   values[t]      parsed int64 of token t, or NONINT
 *   line_tokens[r] number of tokens on line r (empty lines skipped)
 * Returns number of (non-empty) lines; negative on overflow:
 *   -1 too many tokens (> max_tokens), -2 too many lines (> max_lines).
 */
long long tokenize_ints(const char *buf, long long len,
                        int64_t *values, long long max_tokens,
                        int64_t *line_tokens, long long max_lines) {
    long long t = 0, line = 0, in_line_tokens = 0;
    long long i = 0;
    while (i < len) {
        char c = buf[i];
        if (c == '\n') {
            if (in_line_tokens > 0) {
                if (line >= max_lines) return -2;
                line_tokens[line++] = in_line_tokens;
                in_line_tokens = 0;
            }
            i++;
            continue;
        }
        if (c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f') {
            i++;
            continue;
        }
        /* token start */
        long long start = i;
        int64_t val = 0;
        int neg = 0, is_int = 1, digits = 0;
        if (buf[i] == '-' || buf[i] == '+') {
            neg = (buf[i] == '-');
            i++;
        }
        while (i < len) {
            char d = buf[i];
            if (d == ' ' || d == '\t' || d == '\n' || d == '\r' ||
                d == '\v' || d == '\f')
                break;
            if (d >= '0' && d <= '9') {
                val = val * 10 + (d - '0');
                digits++;
                if (digits > 18) is_int = 0;
            } else {
                is_int = 0;
            }
            i++;
        }
        (void)start;
        if (t >= max_tokens) return -1;
        values[t++] = (is_int && digits > 0) ? (neg ? -val : val) : NONINT;
        in_line_tokens++;
    }
    if (in_line_tokens > 0) {
        if (line >= max_lines) return -2;
        line_tokens[line++] = in_line_tokens;
    }
    return line;
}
