// Native data-path kernels for the tokenized dataset pipeline.
//
// The reference keeps its data path in Python (json.loads per sample inside
// PackedDataset.build_pack); at scale the per-line JSON parse dominates host
// time.  These two functions replace it:
//   parse_tokens: extract the integer array from a  {"tokens": [..]}  line
//   build_meta:   scan a whole .bin, emitting (byte_offset, token_count) rows
//                 (the .bin.meta index, reference tools/tokenizer.py
//                 prepare_meta / single_dataset.py)
//
// Exposed with C linkage for ctypes; see internevo_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>

extern "C" {

// Parse the first JSON array of integers in buf[0:len) into out (capacity
// max_out).  Returns the number of integers, or -1 on malformed/overflow.
long parse_tokens(const char* buf, long len, int32_t* out, long max_out) {
    long i = 0;
    while (i < len && buf[i] != '[') i++;
    if (i == len) return -1;
    i++;
    long n = 0;
    while (i < len) {
        // skip whitespace and commas
        while (i < len && (buf[i] == ' ' || buf[i] == ',' || buf[i] == '\n' || buf[i] == '\r' || buf[i] == '\t')) i++;
        if (i < len && buf[i] == ']') return n;
        bool neg = false;
        if (i < len && buf[i] == '-') { neg = true; i++; }
        if (i >= len || buf[i] < '0' || buf[i] > '9') return -1;
        int64_t v = 0;
        while (i < len && buf[i] >= '0' && buf[i] <= '9') {
            v = v * 10 + (buf[i] - '0');
            i++;
        }
        if (n >= max_out) return -1;
        out[n++] = (int32_t)(neg ? -v : v);
    }
    return -1;  // no closing bracket
}

// Count the integers in the first JSON array of the line (no output buffer).
static long count_tokens(const char* buf, long len) {
    long i = 0;
    while (i < len && buf[i] != '[') i++;
    if (i == len) return -1;
    i++;
    long n = 0;
    bool in_number = false;
    for (; i < len; i++) {
        char c = buf[i];
        if (c == ']') return n;
        if ((c >= '0' && c <= '9') || c == '-') {
            if (!in_number) { n++; in_number = true; }
        } else {
            in_number = false;
        }
    }
    return -1;
}

// Scan the whole file buffer, one JSON object per line; fill offsets[] and
// counts[] (each capacity max_rows).  Returns the number of rows, or -1.
long build_meta(const char* buf, long len, int64_t* offsets, int64_t* counts, long max_rows) {
    long row = 0;
    long pos = 0;
    while (pos < len) {
        const char* nl = (const char*)memchr(buf + pos, '\n', (size_t)(len - pos));
        long line_end = nl ? (long)(nl - buf) : len;
        if (line_end > pos) {
            long n = count_tokens(buf + pos, line_end - pos);
            if (n < 0) return -1;
            if (row >= max_rows) return -1;
            offsets[row] = pos;
            counts[row] = n;
            row++;
        }
        pos = line_end + 1;
    }
    return row;
}

}  // extern "C"
