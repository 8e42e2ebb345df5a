// Native twin of the WordPiece text tokenizer (tokenizers/text.py).
//
// The reference delegates paragraph tokenization to an HF fast tokenizer,
// which is native (Rust) code; this is the equivalent native layer for the
// rebuild. Scope: the ASCII path only — scientific corpus text is almost
// entirely ASCII, and the python wrapper (tokenizers/native.py) routes any
// non-ASCII text through the python implementation, so the pair is
// bit-identical to text.py by construction:
//   clean:      \t\n\r and space -> ' ', other control chars (<0x20, 0x7F)
//               deleted (text.py _ASCII_CLEAN)
//   basic:      split on spaces, ASCII lowercase (accent strip is identity
//               on ASCII), split punctuation chars (ASCII ranges 33-47,
//               58-64, 91-96, 123-126) into single tokens
//   wordpiece:  greedy longest-match-first with "##" continuation, [UNK]
//               for unmatchable or >max_chars words (text.py wordpiece())
//
// Parity is asserted by tests/test_native_tokenizer.py fuzz.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Encoder {
    std::unordered_map<std::string, int32_t> vocab;
    int32_t unk_id = 0;
};

std::vector<Encoder*> g_encoders;

inline bool is_ascii_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

}  // namespace

extern "C" {

// vocab tokens as concatenated bytes + n+1 offsets + parallel ids (vocab
// ids are line numbers and may have gaps); returns a handle.
int32_t ctok_encoder_new(const char* data, const int32_t* offs,
                         const int32_t* ids, int32_t n, int32_t unk_id) {
    Encoder* e = new Encoder();
    e->vocab.reserve(static_cast<size_t>(n) * 2);
    for (int32_t i = 0; i < n; ++i) {
        e->vocab.emplace(std::string(data + offs[i], data + offs[i + 1]),
                         ids[i]);
    }
    e->unk_id = unk_id;
    g_encoders.push_back(e);
    return static_cast<int32_t>(g_encoders.size()) - 1;
}

void ctok_encoder_free(int32_t handle) {
    if (handle >= 0 && handle < static_cast<int32_t>(g_encoders.size()) &&
        g_encoders[handle]) {
        delete g_encoders[handle];
        g_encoders[handle] = nullptr;
    }
}

// Encode one ASCII text to wordpiece ids (no CLS/SEP). Returns the id
// count, -1 if `out` is too small, -2 on any non-ASCII byte (caller must
// use the python path), -3 on a bad handle.
int32_t ctok_encode(int32_t handle, const char* text, int32_t text_len,
                    int32_t max_chars_per_word, int32_t lower,
                    int32_t* out, int32_t max_out) {
    if (handle < 0 || handle >= static_cast<int32_t>(g_encoders.size()) ||
        !g_encoders[handle])
        return -3;
    const Encoder& enc = *g_encoders[handle];
    int32_t n_out = 0;

    // one basic token (already cleaned/lowered/punct-split) -> wordpiece
    std::string sub;  // lookup scratch
    auto emit_word = [&](const char* w, int32_t len) -> bool {
        if (len > max_chars_per_word) {
            if (n_out >= max_out) return false;
            out[n_out++] = enc.unk_id;
            return true;
        }
        int32_t start = 0;
        int32_t first = n_out;
        while (start < len) {
            int32_t end = len;
            int32_t piece = -1;
            while (start < end) {
                sub.clear();
                if (start > 0) sub += "##";
                sub.append(w + start, w + end);
                auto it = enc.vocab.find(sub);
                if (it != enc.vocab.end()) { piece = it->second; break; }
                --end;
            }
            if (piece < 0) {  // unmatchable word -> single [UNK]
                n_out = first;
                if (n_out >= max_out) return false;
                out[n_out++] = enc.unk_id;
                return true;
            }
            if (n_out >= max_out) return false;
            out[n_out++] = piece;
            start = end;
        }
        return true;
    };

    std::string word;  // current cleaned word (lowered, pre-punct-split)
    auto flush_word = [&]() -> bool {
        if (word.empty()) return true;
        // split punctuation like text.py _split_punct
        size_t seg = 0;
        for (size_t i = 0; i < word.size(); ++i) {
            if (is_ascii_punct(static_cast<unsigned char>(word[i]))) {
                if (i > seg &&
                    !emit_word(word.data() + seg, static_cast<int32_t>(i - seg)))
                    return false;
                if (!emit_word(word.data() + i, 1)) return false;
                seg = i + 1;
            }
        }
        if (seg < word.size() &&
            !emit_word(word.data() + seg,
                       static_cast<int32_t>(word.size() - seg)))
            return false;
        word.clear();
        return true;
    };

    for (int32_t i = 0; i < text_len; ++i) {
        unsigned char c = static_cast<unsigned char>(text[i]);
        if (c >= 0x80) return -2;
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
            if (!flush_word()) return -1;
            continue;
        }
        if (c < 0x20 || c == 0x7F) continue;  // deleted by clean
        if (lower && c >= 'A' && c <= 'Z') c += 32;
        word.push_back(static_cast<char>(c));
    }
    if (!flush_word()) return -1;
    return n_out;
}

// ---------------------------------------------------------------------------
// SMILES scanner: hand-coded equivalent of the Schwaller regex
// (tokenizers/smiles.py SMILES_REGEX_PATTERN) with re.findall semantics —
// at each position the alternatives are tried IN PATTERN ORDER and a
// non-matching character is skipped. Token ids come from the same vocab
// handle (whole-token lookup, [UNK] fallback, no wordpiece), matching
// SmilesTokenizer.tokenize + convert_tokens_to_ids.
//
// Returns the token count, -1 if out too small, -2 on non-ASCII, -3 on a
// bad handle. atom_flags (optional, same length) gets 1 for tokens the
// ATOM_REGEX (smiles.py:26) fully matches: bracket atoms, B/Br, C/Cl,
// N O S P F I, b c n o s p.

extern "C" int32_t ctok_smiles_encode(int32_t handle, const char* text,
                                      int32_t text_len, int32_t* out,
                                      int32_t max_out, int32_t* atom_flags) {
    if (handle < 0 || handle >= static_cast<int32_t>(g_encoders.size()) ||
        !g_encoders[handle])
        return -3;
    const Encoder& enc = *g_encoders[handle];
    int32_t n_out = 0;
    std::string tok;
    int32_t i = 0;
    auto emit = [&](int32_t len, bool atom) -> bool {
        tok.assign(text + i, text + i + len);
        auto it = enc.vocab.find(tok);
        if (n_out >= max_out) return false;
        if (atom_flags) atom_flags[n_out] = atom ? 1 : 0;
        out[n_out++] = (it != enc.vocab.end()) ? it->second : enc.unk_id;
        i += len;
        return true;
    };
    while (i < text_len) {
        unsigned char c = static_cast<unsigned char>(text[i]);
        if (c >= 0x80) return -2;
        int32_t matched = 0;
        bool atom = false;
        switch (c) {
            case '[': {  // \[[^\]]+] — at least one non-']' then ']'
                int32_t j = i + 1;
                while (j < text_len && text[j] != ']') {
                    if (static_cast<unsigned char>(text[j]) >= 0x80) return -2;
                    ++j;
                }
                if (j < text_len && j > i + 1) { matched = j - i + 1; atom = true; }
                break;
            }
            case 'B':  // Br?
                matched = (i + 1 < text_len && text[i + 1] == 'r') ? 2 : 1;
                atom = true;
                break;
            case 'C':  // Cl?
                matched = (i + 1 < text_len && text[i + 1] == 'l') ? 2 : 1;
                atom = true;
                break;
            case 'N': case 'O': case 'S': case 'P': case 'F': case 'I':
            case 'b': case 'c': case 'n': case 'o': case 's': case 'p':
                matched = 1; atom = true; break;
            case '(': case ')': case '.': case '=': case '#': case '-':
            case '+': case '\\': case '/': case ':': case '~': case '@':
            case '?': case '*': case '$':
                matched = 1; break;
            case '>':  // >>? — greedy
                matched = (i + 1 < text_len && text[i + 1] == '>') ? 2 : 1;
                break;
            case '%':  // %[0-9]{2}
                if (i + 2 < text_len && text[i + 1] >= '0' && text[i + 1] <= '9'
                    && text[i + 2] >= '0' && text[i + 2] <= '9')
                    matched = 3;
                break;
            default:
                if (c >= '0' && c <= '9') matched = 1;
                break;
        }
        if (matched == 0) { ++i; continue; }  // findall skips non-matches
        if (!emit(matched, atom)) return -1;
    }
    return n_out;
}

}  // extern "C"
