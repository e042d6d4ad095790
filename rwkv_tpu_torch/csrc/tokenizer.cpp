// Native byte-level BPE tokenizer for rwkv_tpu_torch.
//
// The C++ counterpart of the port's Python tokenizer
// (rwkv_tpu_torch/tokenizer/bpe.py): the same GPT-2-style byte-level BPE,
// its own minimal JSON parser, a hash-based merge loop, UTF-8-correct
// decode and a C ABI for ctypes (rwkv_tpu_torch/tokenizer/native.py).
// A copy of the JAX package's native/tokenizer.cpp with one change: decode
// maps a character outside the GPT-2 byte alphabet to its own UTF-8 bytes,
// as the Python tokenizer's decode_bytes does. The 20B vocab's 23 added
// tokens (ids 50254..50276, runs of 2 to 24 plain spaces) hold such
// characters; the original dropped them and decoded those ids to nothing.
//
// Build: g++ -O2 -std=c++17 -fPIC -shared tokenizer.cpp -o librwkv_tok.so
// (tokenizer/native.py::build does it, into rwkv_tpu_torch/_build/).
//
// ABI:
//   void*  rwkv_tok_load(const char* vocab_json, const char* merges_txt);
//   int    rwkv_tok_vocab_size(void* h);
//   long   rwkv_tok_encode(void* h, const char* text, int32_t* out, long cap);
//   long   rwkv_tok_decode(void* h, const int32_t* ids, long n,
//                          char* out, long cap);   // returns byte length
//   void   rwkv_tok_free(void* h);

#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- utf-8
void append_codepoint(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
        out.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
        out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
        out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
}

size_t cp_len(unsigned char c) {
    if ((c & 0xF8) == 0xF0) return 4;
    if ((c & 0xF0) == 0xE0) return 3;
    if ((c & 0xE0) == 0xC0) return 2;
    return 1;
}

uint32_t decode_cp(const char* s, size_t len) {
    const unsigned char* u = reinterpret_cast<const unsigned char*>(s);
    switch (len) {
        case 1: return u[0];
        case 2: return ((u[0] & 0x1F) << 6) | (u[1] & 0x3F);
        case 3: return ((u[0] & 0x0F) << 12) | ((u[1] & 0x3F) << 6) | (u[2] & 0x3F);
        default:
            return ((u[0] & 0x07) << 18) | ((u[1] & 0x3F) << 12) |
                   ((u[2] & 0x3F) << 6) | (u[3] & 0x3F);
    }
}

// ------------------------------------------------- GPT-2 byte<->unicode map
// Printable latin ranges map to themselves; everything else maps to 256+n.
void build_byte_maps(std::string byte_to_uni[256],
                     std::unordered_map<uint32_t, uint8_t>& uni_to_byte) {
    bool direct[256] = {false};
    for (int b = '!'; b <= '~'; ++b) direct[b] = true;
    for (int b = 0xA1; b <= 0xAC; ++b) direct[b] = true;
    for (int b = 0xAE; b <= 0xFF; ++b) direct[b] = true;
    int n = 0;
    for (int b = 0; b < 256; ++b) {
        uint32_t cp = direct[b] ? static_cast<uint32_t>(b)
                                : static_cast<uint32_t>(256 + n++);
        std::string s;
        append_codepoint(s, cp);
        byte_to_uni[b] = s;
        uni_to_byte[cp] = static_cast<uint8_t>(b);
    }
}

// ---------------------------------------------------------- tiny JSON reader
// vocab.json is one flat object {"token": int, ...}; parse exactly that.
struct JsonCursor {
    const char* p;
    const char* end;
    bool fail = false;

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
            ++p;
    }
    bool expect(char c) {
        skip_ws();
        if (p < end && *p == c) { ++p; return true; }
        fail = true;
        return false;
    }
    bool parse_string(std::string& out) {
        skip_ws();
        if (p >= end || *p != '"') { fail = true; return false; }
        ++p;
        out.clear();
        while (p < end && *p != '"') {
            if (*p == '\\') {
                ++p;
                if (p >= end) { fail = true; return false; }
                switch (*p) {
                    case '"': out.push_back('"'); ++p; break;
                    case '\\': out.push_back('\\'); ++p; break;
                    case '/': out.push_back('/'); ++p; break;
                    case 'b': out.push_back('\b'); ++p; break;
                    case 'f': out.push_back('\f'); ++p; break;
                    case 'n': out.push_back('\n'); ++p; break;
                    case 'r': out.push_back('\r'); ++p; break;
                    case 't': out.push_back('\t'); ++p; break;
                    case 'u': {
                        if (end - p < 5) { fail = true; return false; }
                        uint32_t cp = static_cast<uint32_t>(
                            std::stoul(std::string(p + 1, p + 5), nullptr, 16));
                        p += 5;
                        // surrogate pair
                        if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 &&
                            p[0] == '\\' && p[1] == 'u') {
                            uint32_t lo = static_cast<uint32_t>(
                                std::stoul(std::string(p + 2, p + 6), nullptr, 16));
                            if (lo >= 0xDC00 && lo <= 0xDFFF) {
                                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                                p += 6;
                            }
                        }
                        append_codepoint(out, cp);
                        break;
                    }
                    default: fail = true; return false;
                }
            } else {
                out.push_back(*p++);
            }
        }
        if (p >= end) { fail = true; return false; }
        ++p;  // closing quote
        return true;
    }
    bool parse_int(long& out) {
        skip_ws();
        char* e = nullptr;
        out = std::strtol(p, &e, 10);
        if (e == p) { fail = true; return false; }
        p = e;
        return true;
    }
};

struct PairHash {
    size_t operator()(const std::pair<std::string, std::string>& pr) const {
        std::hash<std::string> h;
        size_t a = h(pr.first);
        a ^= h(pr.second) + 0x9e3779b97f4a7c15ull + (a << 6) + (a >> 2);
        return a;
    }
};

struct Tokenizer {
    std::unordered_map<std::string, int32_t> encoder;
    std::vector<std::string> decoder;  // id -> mapped-unicode token
    std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
        ranks;
    std::string byte_to_uni[256];
    std::unordered_map<uint32_t, uint8_t> uni_to_byte;
    std::unordered_map<std::string, std::vector<int32_t>> cache;

    // greedy lowest-rank merge of one pre-token (already byte->unicode mapped)
    void bpe(const std::string& token, std::vector<int32_t>& out) {
        auto it = cache.find(token);
        if (it != cache.end()) {
            out.insert(out.end(), it->second.begin(), it->second.end());
            return;
        }
        std::vector<std::string> word;
        for (size_t i = 0; i < token.size();) {
            size_t l = cp_len(static_cast<unsigned char>(token[i]));
            word.emplace_back(token.substr(i, l));
            i += l;
        }
        while (word.size() > 1) {
            int32_t best_rank = INT32_MAX;
            size_t best_i = 0;
            for (size_t i = 0; i + 1 < word.size(); ++i) {
                auto r = ranks.find({word[i], word[i + 1]});
                if (r != ranks.end() && r->second < best_rank) {
                    best_rank = r->second;
                    best_i = i;
                }
            }
            if (best_rank == INT32_MAX) break;
            const std::string first = word[best_i];
            const std::string second = word[best_i + 1];
            // merge every occurrence of (first, second), left to right
            std::vector<std::string> merged;
            merged.reserve(word.size());
            for (size_t i = 0; i < word.size();) {
                if (i + 1 < word.size() && word[i] == first &&
                    word[i + 1] == second) {
                    merged.emplace_back(first + second);
                    i += 2;
                } else {
                    merged.emplace_back(word[i]);
                    i += 1;
                }
            }
            word.swap(merged);
        }
        std::vector<int32_t> ids;
        ids.reserve(word.size());
        for (const auto& piece : word) {
            auto e = encoder.find(piece);
            if (e != encoder.end()) ids.push_back(e->second);
        }
        if (token.size() < 24) cache.emplace(token, ids);
        out.insert(out.end(), ids.begin(), ids.end());
    }
};

// --------------------------------------------------- GPT-2 pre-tokenization
// Equivalent of  's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|
//                 ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
// over UTF-8, with unicode letter/number classification delegated to a
// compact check (exact for ASCII; conservative ranges otherwise).
bool cp_is_space(uint32_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f' || c == 0x85 || c == 0xA0 || (c >= 0x2000 && c <= 0x200A) ||
           c == 0x1680 || c == 0x2028 || c == 0x2029 || c == 0x202F ||
           c == 0x205F || c == 0x3000;
}

bool cp_is_digit(uint32_t c) {
    if (c < 128) return c >= '0' && c <= '9';
    // common unicode decimal ranges (Arabic-Indic, Devanagari, etc.)
    return (c >= 0x0660 && c <= 0x0669) || (c >= 0x06F0 && c <= 0x06F9) ||
           (c >= 0x0966 && c <= 0x096F) || (c >= 0x09E6 && c <= 0x09EF) ||
           (c >= 0x0E50 && c <= 0x0E59) || (c >= 0xFF10 && c <= 0xFF19) ||
           (c >= 0x00B2 && c <= 0x00B3) || c == 0x00B9 ||
           (c >= 0x00BC && c <= 0x00BE);
}

bool cp_is_letter(uint32_t c) {
    if (c < 128)
        return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
    if (cp_is_space(c) || cp_is_digit(c)) return false;
    // Approximation of \p{L} for the BMP+SMP: treat general punctuation,
    // symbols, and marks blocks as non-letters; letters otherwise.
    if (c >= 0x2000 && c <= 0x2BFF) return false;   // punct/symbols/arrows
    if (c >= 0x3000 && c <= 0x303F) return false;   // CJK punct
    if (c >= 0xFE30 && c <= 0xFE4F) return false;
    if (c >= 0xFF00 && c <= 0xFF0F) return false;   // fullwidth punct
    if (c >= 0xFF1A && c <= 0xFF20) return false;
    if (c >= 0xFF3B && c <= 0xFF40) return false;
    if (c >= 0xFF5B && c <= 0xFF65) return false;
    if (c >= 0x1F000) return false;                 // emoji planes
    if (c >= 0x00A0 && c <= 0x00BF) return false;   // latin-1 punct/symbols
    if (c == 0x00D7 || c == 0x00F7) return false;
    if (c >= 0x0300 && c <= 0x036F) return false;   // combining marks
    return true;
}

struct CpStream {
    const char* p;
    const char* end;
    bool done() const { return p >= end; }
    uint32_t peek(size_t* len) const {
        size_t l = cp_len(static_cast<unsigned char>(*p));
        if (p + l > end) l = 1;
        *len = l;
        return decode_cp(p, l);
    }
};

void pretokenize(const std::string& text, std::vector<std::string>& out) {
    CpStream s{text.data(), text.data() + text.size()};
    while (!s.done()) {
        const char* start = s.p;
        size_t l;
        uint32_t c = s.peek(&l);

        // contractions: 's 't 're 've 'm 'll 'd
        if (c == '\'' && s.p + 1 < s.end) {
            const char* q = s.p + 1;
            size_t rem = static_cast<size_t>(s.end - q);
            auto is = [&](const char* suf, size_t n) {
                return rem >= n && std::strncmp(q, suf, n) == 0;
            };
            size_t take = 0;
            if (is("re", 2) || is("ve", 2) || is("ll", 2)) take = 3;
            else if (is("s", 1) || is("t", 1) || is("m", 1) || is("d", 1)) take = 2;
            if (take) {
                out.emplace_back(s.p, take);
                s.p += take;
                continue;
            }
        }

        bool led_space = false;
        if (c == ' ') {
            // " ?\p{L}+" / " ?\p{N}+" / " ?[^...]+" may consume one space
            const char* save = s.p;
            s.p += l;
            if (!s.done()) {
                size_t l2;
                uint32_t c2 = s.peek(&l2);
                if (!cp_is_space(c2)) {
                    led_space = true;
                    c = c2;
                    l = l2;
                } else {
                    s.p = save;
                }
            } else {
                s.p = save;
            }
        }

        if (!led_space && cp_is_space(c)) {
            // \s+(?!\S) | \s+  : take the whitespace run; if a non-space
            // follows, leave the LAST space codepoint for the next match
            // (an ASCII ' ' joins it via the " ?" prefix; any other space
            // becomes its own single-codepoint token, exactly like the
            // regex backtracking). The run must be counted in CODEPOINTS:
            // counting bytes made a single 2-byte space (NBSP) look like a
            // run of two, back up over itself, and loop forever (caught by
            // tests/fixtures/golden_tokens.json case "nbsp\xc2\xa0space").
            const char* ws_start = s.p;
            const char* last_cp = s.p;
            size_t run_cp = 0;
            while (!s.done()) {
                size_t l3;
                uint32_t c3 = s.peek(&l3);
                if (!cp_is_space(c3)) break;
                last_cp = s.p;
                s.p += l3;
                run_cp++;
            }
            const char* ws_end = s.p;
            if (!s.done() && run_cp > 1) {
                // lookahead failed for the last space; it prefixes (or
                // forms) the next token
                ws_end = last_cp;
                s.p = ws_end;
            }
            if (ws_end > ws_start) out.emplace_back(ws_start, ws_end - ws_start);
            continue;
        }

        if (cp_is_letter(c)) {
            s.p += l;
            while (!s.done()) {
                size_t l3;
                uint32_t c3 = s.peek(&l3);
                if (!cp_is_letter(c3)) break;
                s.p += l3;
            }
        } else if (cp_is_digit(c)) {
            s.p += l;
            while (!s.done()) {
                size_t l3;
                uint32_t c3 = s.peek(&l3);
                if (!cp_is_digit(c3)) break;
                s.p += l3;
            }
        } else {
            s.p += l;
            while (!s.done()) {
                size_t l3;
                uint32_t c3 = s.peek(&l3);
                if (cp_is_space(c3) || cp_is_letter(c3) || cp_is_digit(c3))
                    break;
                s.p += l3;
            }
        }
        out.emplace_back(start, s.p - start);
    }
}

}  // namespace

extern "C" {

void* rwkv_tok_load(const char* vocab_json, const char* merges_txt) {
    auto* t = new Tokenizer();
    build_byte_maps(t->byte_to_uni, t->uni_to_byte);

    {
        std::ifstream f(vocab_json, std::ios::binary);
        if (!f.good()) { delete t; return nullptr; }
        std::stringstream ss;
        ss << f.rdbuf();
        std::string data = ss.str();
        JsonCursor c{data.data(), data.data() + data.size()};
        if (!c.expect('{')) { delete t; return nullptr; }
        c.skip_ws();
        if (c.p < c.end && *c.p == '}') { ++c.p; }
        else {
            while (true) {
                std::string key;
                long val;
                if (!c.parse_string(key) || !c.expect(':') || !c.parse_int(val)) {
                    delete t;
                    return nullptr;
                }
                t->encoder.emplace(key, static_cast<int32_t>(val));
                if (static_cast<size_t>(val) >= t->decoder.size())
                    t->decoder.resize(val + 1);
                t->decoder[val] = key;
                c.skip_ws();
                if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
                break;
            }
            if (!c.expect('}')) { delete t; return nullptr; }
        }
    }
    {
        std::ifstream f(merges_txt);
        if (!f.good()) { delete t; return nullptr; }
        std::string line;
        std::getline(f, line);  // version header
        int32_t rank = 0;
        while (std::getline(f, line)) {
            if (line.empty()) continue;
            size_t sp = line.find(' ');
            if (sp == std::string::npos) continue;
            t->ranks.emplace(
                std::make_pair(line.substr(0, sp), line.substr(sp + 1)), rank++);
        }
    }
    return t;
}

int rwkv_tok_vocab_size(void* h) {
    return static_cast<int>(static_cast<Tokenizer*>(h)->encoder.size());
}

long rwkv_tok_encode(void* h, const char* text, int32_t* out, long cap) {
    auto* t = static_cast<Tokenizer*>(h);
    std::vector<std::string> pieces;
    pretokenize(text, pieces);
    std::vector<int32_t> ids;
    std::string mapped;
    for (const auto& piece : pieces) {
        mapped.clear();
        for (unsigned char b : piece) mapped += t->byte_to_uni[b];
        t->bpe(mapped, ids);
    }
    long n = static_cast<long>(ids.size());
    if (out && cap > 0)
        std::memcpy(out, ids.data(),
                    sizeof(int32_t) * static_cast<size_t>(std::min(n, cap)));
    return n;
}

long rwkv_tok_decode(void* h, const int32_t* ids, long n, char* out, long cap) {
    auto* t = static_cast<Tokenizer*>(h);
    std::string bytes;
    for (long i = 0; i < n; ++i) {
        int32_t id = ids[i];
        if (id < 0 || static_cast<size_t>(id) >= t->decoder.size()) continue;
        const std::string& tok = t->decoder[id];
        for (size_t j = 0; j < tok.size();) {
            size_t l = cp_len(static_cast<unsigned char>(tok[j]));
            uint32_t cp = decode_cp(tok.data() + j, l);
            auto b = t->uni_to_byte.find(cp);
            if (b != t->uni_to_byte.end())
                bytes.push_back(static_cast<char>(b->second));
            else  // an added token's plain character: its own UTF-8 bytes
                bytes.append(tok, j, l);
            j += l;
        }
    }
    long len = static_cast<long>(bytes.size());
    if (out && cap > 0)
        std::memcpy(out, bytes.data(),
                    static_cast<size_t>(std::min(len, cap)));
    return len;
}

void rwkv_tok_free(void* h) { delete static_cast<Tokenizer*>(h); }

}  // extern "C"
