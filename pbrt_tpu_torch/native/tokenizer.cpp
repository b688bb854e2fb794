// Native scene-file tokenizer for the .pbrt grammar.
//
// Reference analogue: the C++ Tokenizer of
// /root/reference/src/pbrt/parser.h:25-140 (pbrt's parsing is native; this
// framework keeps that choice — Python tokenization dominated parse time on
// multi-megabyte scene files, ~20x slower than this pass).
//
// Contract (ctypes, see native/__init__.py):
//   int64 tokenize(const char* text, int64 len,
//                  int32* starts, int32* ends, int8* kinds, double* values,
//                  int64 max_tokens);
// Fills per-token (start, end) byte offsets, a kind tag
// (0 = bare token, 1 = quoted string INCLUDING quotes, 2 = '[', 3 = ']',
//  4 = number, with `values` holding the parsed double), and returns the
// token count (or -needed if max_tokens is too small).

#include <cstdint>
#include <cstdlib>
#include <cctype>

extern "C" {

long long tokenize(const char* text, long long n,
                   int* starts, int* ends, signed char* kinds,
                   double* values, long long max_tokens) {
    long long count = 0;
    long long i = 0;
    while (i < n) {
        char c = text[i];
        if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
            ++i;
            continue;
        }
        if (c == '#') {  // comment to end of line
            while (i < n && text[i] != '\n') ++i;
            continue;
        }
        long long start = i;
        signed char kind;
        double value = 0.0;
        if (c == '"') {
            ++i;
            while (i < n && text[i] != '"') ++i;
            ++i;  // closing quote
            kind = 1;
        } else if (c == '[') {
            ++i;
            kind = 2;
        } else if (c == ']') {
            ++i;
            kind = 3;
        } else {
            while (i < n) {
                char d = text[i];
                if (d == ' ' || d == '\t' || d == '\r' || d == '\n' ||
                    d == '"' || d == '[' || d == ']' || d == '#')
                    break;
                ++i;
            }
            // Numeric literal? strtod must consume the whole span.
            char* endp = nullptr;
            value = strtod(text + start, &endp);
            if (endp == text + i) {
                kind = 4;
            } else {
                kind = 0;
            }
        }
        if (count < max_tokens) {
            starts[count] = (int)start;
            ends[count] = (int)i;
            kinds[count] = kind;
            values[count] = value;
        }
        ++count;
    }
    if (count > max_tokens) return -count;
    return count;
}

}  // extern "C"
