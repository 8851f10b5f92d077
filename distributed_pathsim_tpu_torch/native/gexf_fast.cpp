// Fast streaming GEXF parser (the port's native data loader).
//
// The reference's loader is networkx.read_gexf through Python XML DOM
// (reference DPathSim_APVPA.py:114-129) — fine for 2k nodes, minutes for
// millions. This is a single-pass, zero-dependency tokenizer over the
// GEXF subset the DBLP datasets use (nodes/edges with attvalues), with
// the exact semantics of the Python fallback in ../data/gexf.py:
//   - node_type   := node attvalue whose declared title is "node_type"
//   - relationship:= edge attvalue whose declared title is "label"
//                    (falling back to the edge's label= XML attribute)
//   - label       := node label= attribute, falling back to id
//   - duplicate (src,dst) edges keep first position, last relationship
//     (networkx DiGraph attribute-overwrite behavior)
//   - document order preserved (it drives the reference's log order)
//
// C ABI: results are returned as two NUL-separated string blobs
// (id\0label\0type\0 per node; src\0dst\0rel\0 per edge) consumed by
// ctypes in gexf_native.py.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Attr {
  std::string name;
  std::string value;
};

// ---------------------------------------------------------------------------
// Strictness (r04 differential fuzz): the native parser is the DEFAULT
// loader, and a 400-case mutation fuzz against the Python (expat) path
// found 86 inputs expat rejects that this tokenizer silently loaded —
// truncations, bad entities, byte corruption. A corrupted file must
// fail loudly, not load partially; these checks close every divergence
// class the fuzz surfaced (tests/test_native.py::test_differential_fuzz).
// ---------------------------------------------------------------------------

// Whole-document scan: reject invalid UTF-8 (incl. overlongs and
// surrogates) and control characters outside {\t, \n, \r} — expat
// refuses both wherever they appear (text, attributes, comments).
bool validate_document(const std::string& data, std::string* err) {
  const auto* s = reinterpret_cast<const unsigned char*>(data.data());
  size_t n = data.size();
  for (size_t i = 0; i < n;) {
    unsigned char c = s[i];
    if (c < 0x80) {
      if (c < 0x20 && c != '\t' && c != '\n' && c != '\r') {
        *err = "invalid control character";
        return false;
      }
      ++i;
      continue;
    }
    int len;
    if (c >= 0xC2 && c <= 0xDF) len = 2;
    else if (c >= 0xE0 && c <= 0xEF) len = 3;
    else if (c >= 0xF0 && c <= 0xF4) len = 4;
    else {  // continuation byte as lead, overlong lead, or > U+10FFFF
      *err = "invalid UTF-8";
      return false;
    }
    if (i + len > n) {
      *err = "truncated UTF-8 sequence";
      return false;
    }
    for (int k = 1; k < len; ++k) {
      if ((s[i + k] & 0xC0) != 0x80) {
        *err = "invalid UTF-8";
        return false;
      }
    }
    if ((c == 0xE0 && s[i + 1] < 0xA0) ||   // overlong 3-byte
        (c == 0xED && s[i + 1] >= 0xA0) ||  // UTF-16 surrogate
        (c == 0xF0 && s[i + 1] < 0x90) ||   // overlong 4-byte
        (c == 0xF4 && s[i + 1] >= 0x90)) {  // > U+10FFFF
      *err = "invalid UTF-8";
      return false;
    }
    // U+FFFE / U+FFFF (EF BF BE / EF BF BF) are not XML Chars; expat
    // rejects the literal bytes just like the numeric references.
    if (c == 0xEF && s[i + 1] == 0xBF &&
        (s[i + 2] == 0xBE || s[i + 2] == 0xBF)) {
      *err = "XML-invalid character U+FFFE/U+FFFF";
      return false;
    }
    i += len;
  }
  return true;
}

// Decode the five XML built-in entities plus numeric references —
// STRICT: unknown entities, bare '&', and numeric references to
// XML-invalid code points are errors (expat parity), never passed
// through. Entities are parsed inline (no arbitrary length cap —
// numeric references may carry leading zeros). ``out`` may be null to
// validate without building a string; when non-null (attribute
// values), literal whitespace normalizes to spaces the way expat's
// attribute-value normalization does (\r\n → one space; character
// REFERENCES like &#10; stay literal, per the XML spec).
bool decode_entities_strict(const char* s, size_t n, std::string* out,
                            std::string* err) {
  for (size_t i = 0; i < n;) {
    char c = s[i];
    if (c != '&') {
      if (c == '\r' && i + 1 < n && s[i + 1] == '\n') ++i;  // CRLF → LF
      if (out) {
        *out += (c == '\r' || c == '\n' || c == '\t') ? ' ' : c;
      }
      ++i;
      continue;
    }
    size_t j = i + 1;
    if (j < n && s[j] == '#') {
      ++j;
      bool hex = false;
      if (j < n && (s[j] == 'x' || s[j] == 'X')) {
        hex = true;
        ++j;
      }
      size_t d0 = j;
      long cp = 0;
      for (; j < n; ++j) {
        char ch = s[j];
        int digit;
        if (ch >= '0' && ch <= '9') digit = ch - '0';
        else if (hex && ch >= 'a' && ch <= 'f') digit = ch - 'a' + 10;
        else if (hex && ch >= 'A' && ch <= 'F') digit = ch - 'A' + 10;
        else break;
        if (cp <= 0x10FFFF) cp = cp * (hex ? 16 : 10) + digit;
        // saturates: once past the Unicode range further digits can't
        // bring it back, and the range check below rejects it
      }
      if (j == d0 || j >= n || s[j] != ';') {
        *err = "malformed numeric character reference";
        return false;
      }
      // XML 1.0 Char production: no control chars (except \t\n\r), no
      // surrogates, no U+FFFE/U+FFFF, nothing past U+10FFFF.
      if (cp > 0x10FFFF ||
          (cp < 0x20 && cp != 0x9 && cp != 0xA && cp != 0xD) ||
          (cp >= 0xD800 && cp <= 0xDFFF) || cp == 0xFFFE || cp == 0xFFFF) {
        *err = "numeric reference to XML-invalid character";
        return false;
      }
      if (out) {
        if (cp < 0x80) *out += static_cast<char>(cp);
        else if (cp < 0x800) {
          *out += static_cast<char>(0xC0 | (cp >> 6));
          *out += static_cast<char>(0x80 | (cp & 0x3F));
        } else if (cp < 0x10000) {
          *out += static_cast<char>(0xE0 | (cp >> 12));
          *out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
          *out += static_cast<char>(0x80 | (cp & 0x3F));
        } else {
          *out += static_cast<char>(0xF0 | (cp >> 18));
          *out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
          *out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
          *out += static_cast<char>(0x80 | (cp & 0x3F));
        }
      }
      i = j + 1;
      continue;
    }
    size_t e0 = j;
    while (j < n &&
           ((s[j] >= 'a' && s[j] <= 'z') || (s[j] >= 'A' && s[j] <= 'Z') ||
            (s[j] >= '0' && s[j] <= '9'))) {
      ++j;
    }
    if (j == e0 || j >= n || s[j] != ';') {
      *err = "bare '&' (unterminated entity reference)";
      return false;
    }
    std::string ent(s + e0, j - e0);
    if (ent == "amp") { if (out) *out += '&'; }
    else if (ent == "lt") { if (out) *out += '<'; }
    else if (ent == "gt") { if (out) *out += '>'; }
    else if (ent == "quot") { if (out) *out += '"'; }
    else if (ent == "apos") { if (out) *out += '\''; }
    else {
      *err = "unknown entity '&" + ent + ";'";
      return false;
    }
    i = j + 1;
  }
  return true;
}

// 202 ranges, derived empirically from this build's
// expat (scripts/derive tool in r04 commit message)
constexpr unsigned kNameStartRanges[][2] = {
    {0xc0, 0xd6}, {0xd8, 0xf6}, {0xf8, 0x131}, {0x134, 0x13e},
    {0x141, 0x148}, {0x14a, 0x17e}, {0x180, 0x1c3}, {0x1cd, 0x1f0},
    {0x1f4, 0x1f5}, {0x1fa, 0x217}, {0x250, 0x2a8}, {0x2bb, 0x2c1},
    {0x386, 0x386}, {0x388, 0x38a}, {0x38c, 0x38c}, {0x38e, 0x3a1},
    {0x3a3, 0x3ce}, {0x3d0, 0x3d6}, {0x3da, 0x3da}, {0x3dc, 0x3dc},
    {0x3de, 0x3de}, {0x3e0, 0x3e0}, {0x3e2, 0x3f3}, {0x401, 0x40c},
    {0x40e, 0x44f}, {0x451, 0x45c}, {0x45e, 0x481}, {0x490, 0x4c4},
    {0x4c7, 0x4c8}, {0x4cb, 0x4cc}, {0x4d0, 0x4eb}, {0x4ee, 0x4f5},
    {0x4f8, 0x4f9}, {0x531, 0x556}, {0x559, 0x559}, {0x561, 0x586},
    {0x5d0, 0x5ea}, {0x5f0, 0x5f2}, {0x621, 0x63a}, {0x641, 0x64a},
    {0x671, 0x6b7}, {0x6ba, 0x6be}, {0x6c0, 0x6ce}, {0x6d0, 0x6d3},
    {0x6d5, 0x6d5}, {0x6e5, 0x6e6}, {0x905, 0x939}, {0x93d, 0x93d},
    {0x958, 0x961}, {0x985, 0x98c}, {0x98f, 0x990}, {0x993, 0x9a8},
    {0x9aa, 0x9b0}, {0x9b2, 0x9b2}, {0x9b6, 0x9b9}, {0x9dc, 0x9dd},
    {0x9df, 0x9e1}, {0x9f0, 0x9f1}, {0xa05, 0xa0a}, {0xa0f, 0xa10},
    {0xa13, 0xa28}, {0xa2a, 0xa30}, {0xa32, 0xa33}, {0xa35, 0xa36},
    {0xa38, 0xa39}, {0xa59, 0xa5c}, {0xa5e, 0xa5e}, {0xa72, 0xa74},
    {0xa85, 0xa8b}, {0xa8d, 0xa8d}, {0xa8f, 0xa91}, {0xa93, 0xaa8},
    {0xaaa, 0xab0}, {0xab2, 0xab3}, {0xab5, 0xab9}, {0xabd, 0xabd},
    {0xae0, 0xae0}, {0xb05, 0xb0c}, {0xb0f, 0xb10}, {0xb13, 0xb28},
    {0xb2a, 0xb30}, {0xb32, 0xb33}, {0xb36, 0xb39}, {0xb3d, 0xb3d},
    {0xb5c, 0xb5d}, {0xb5f, 0xb61}, {0xb85, 0xb8a}, {0xb8e, 0xb90},
    {0xb92, 0xb95}, {0xb99, 0xb9a}, {0xb9c, 0xb9c}, {0xb9e, 0xb9f},
    {0xba3, 0xba4}, {0xba8, 0xbaa}, {0xbae, 0xbb5}, {0xbb7, 0xbb9},
    {0xc05, 0xc0c}, {0xc0e, 0xc10}, {0xc12, 0xc28}, {0xc2a, 0xc33},
    {0xc35, 0xc39}, {0xc60, 0xc61}, {0xc85, 0xc8c}, {0xc8e, 0xc90},
    {0xc92, 0xca8}, {0xcaa, 0xcb3}, {0xcb5, 0xcb9}, {0xcde, 0xcde},
    {0xce0, 0xce1}, {0xd05, 0xd0c}, {0xd0e, 0xd10}, {0xd12, 0xd28},
    {0xd2a, 0xd39}, {0xd60, 0xd61}, {0xe01, 0xe2e}, {0xe30, 0xe30},
    {0xe32, 0xe33}, {0xe40, 0xe45}, {0xe81, 0xe82}, {0xe84, 0xe84},
    {0xe87, 0xe88}, {0xe8a, 0xe8a}, {0xe8d, 0xe8d}, {0xe94, 0xe97},
    {0xe99, 0xe9f}, {0xea1, 0xea3}, {0xea5, 0xea5}, {0xea7, 0xea7},
    {0xeaa, 0xeab}, {0xead, 0xeae}, {0xeb0, 0xeb0}, {0xeb2, 0xeb3},
    {0xebd, 0xebd}, {0xec0, 0xec4}, {0xf40, 0xf47}, {0xf49, 0xf69},
    {0x10a0, 0x10c5}, {0x10d0, 0x10f6}, {0x1100, 0x1100}, {0x1102, 0x1103},
    {0x1105, 0x1107}, {0x1109, 0x1109}, {0x110b, 0x110c}, {0x110e, 0x1112},
    {0x113c, 0x113c}, {0x113e, 0x113e}, {0x1140, 0x1140}, {0x114c, 0x114c},
    {0x114e, 0x114e}, {0x1150, 0x1150}, {0x1154, 0x1155}, {0x1159, 0x1159},
    {0x115f, 0x1161}, {0x1163, 0x1163}, {0x1165, 0x1165}, {0x1167, 0x1167},
    {0x1169, 0x1169}, {0x116d, 0x116e}, {0x1172, 0x1173}, {0x1175, 0x1175},
    {0x119e, 0x119e}, {0x11a8, 0x11a8}, {0x11ab, 0x11ab}, {0x11ae, 0x11af},
    {0x11b7, 0x11b8}, {0x11ba, 0x11ba}, {0x11bc, 0x11c2}, {0x11eb, 0x11eb},
    {0x11f0, 0x11f0}, {0x11f9, 0x11f9}, {0x1e00, 0x1e9b}, {0x1ea0, 0x1ef9},
    {0x1f00, 0x1f15}, {0x1f18, 0x1f1d}, {0x1f20, 0x1f45}, {0x1f48, 0x1f4d},
    {0x1f50, 0x1f57}, {0x1f59, 0x1f59}, {0x1f5b, 0x1f5b}, {0x1f5d, 0x1f5d},
    {0x1f5f, 0x1f7d}, {0x1f80, 0x1fb4}, {0x1fb6, 0x1fbc}, {0x1fbe, 0x1fbe},
    {0x1fc2, 0x1fc4}, {0x1fc6, 0x1fcc}, {0x1fd0, 0x1fd3}, {0x1fd6, 0x1fdb},
    {0x1fe0, 0x1fec}, {0x1ff2, 0x1ff4}, {0x1ff6, 0x1ffc}, {0x2126, 0x2126},
    {0x212a, 0x212b}, {0x212e, 0x212e}, {0x2180, 0x2182}, {0x3007, 0x3007},
    {0x3021, 0x3029}, {0x3041, 0x3094}, {0x30a1, 0x30fa}, {0x3105, 0x312c},
    {0x4e00, 0x9fa5}, {0xac00, 0xd7a3},
};
// 282 ranges, derived empirically from this build's
// expat (scripts/derive tool in r04 commit message)
constexpr unsigned kNameCharRanges[][2] = {
    {0xb7, 0xb7}, {0xc0, 0xd6}, {0xd8, 0xf6}, {0xf8, 0x131},
    {0x134, 0x13e}, {0x141, 0x148}, {0x14a, 0x17e}, {0x180, 0x1c3},
    {0x1cd, 0x1f0}, {0x1f4, 0x1f5}, {0x1fa, 0x217}, {0x250, 0x2a8},
    {0x2bb, 0x2c1}, {0x2d0, 0x2d1}, {0x300, 0x345}, {0x360, 0x361},
    {0x386, 0x38a}, {0x38c, 0x38c}, {0x38e, 0x3a1}, {0x3a3, 0x3ce},
    {0x3d0, 0x3d6}, {0x3da, 0x3da}, {0x3dc, 0x3dc}, {0x3de, 0x3de},
    {0x3e0, 0x3e0}, {0x3e2, 0x3f3}, {0x401, 0x40c}, {0x40e, 0x44f},
    {0x451, 0x45c}, {0x45e, 0x481}, {0x483, 0x486}, {0x490, 0x4c4},
    {0x4c7, 0x4c8}, {0x4cb, 0x4cc}, {0x4d0, 0x4eb}, {0x4ee, 0x4f5},
    {0x4f8, 0x4f9}, {0x531, 0x556}, {0x559, 0x559}, {0x561, 0x586},
    {0x591, 0x5a1}, {0x5a3, 0x5b9}, {0x5bb, 0x5bd}, {0x5bf, 0x5bf},
    {0x5c1, 0x5c2}, {0x5c4, 0x5c4}, {0x5d0, 0x5ea}, {0x5f0, 0x5f2},
    {0x621, 0x63a}, {0x640, 0x652}, {0x660, 0x669}, {0x670, 0x6b7},
    {0x6ba, 0x6be}, {0x6c0, 0x6ce}, {0x6d0, 0x6d3}, {0x6d5, 0x6e8},
    {0x6ea, 0x6ed}, {0x6f0, 0x6f9}, {0x901, 0x903}, {0x905, 0x939},
    {0x93c, 0x94d}, {0x951, 0x954}, {0x958, 0x963}, {0x966, 0x96f},
    {0x981, 0x983}, {0x985, 0x98c}, {0x98f, 0x990}, {0x993, 0x9a8},
    {0x9aa, 0x9b0}, {0x9b2, 0x9b2}, {0x9b6, 0x9b9}, {0x9bc, 0x9bc},
    {0x9be, 0x9c4}, {0x9c7, 0x9c8}, {0x9cb, 0x9cd}, {0x9d7, 0x9d7},
    {0x9dc, 0x9dd}, {0x9df, 0x9e3}, {0x9e6, 0x9f1}, {0xa02, 0xa02},
    {0xa05, 0xa0a}, {0xa0f, 0xa10}, {0xa13, 0xa28}, {0xa2a, 0xa30},
    {0xa32, 0xa33}, {0xa35, 0xa36}, {0xa38, 0xa39}, {0xa3c, 0xa3c},
    {0xa3e, 0xa42}, {0xa47, 0xa48}, {0xa4b, 0xa4d}, {0xa59, 0xa5c},
    {0xa5e, 0xa5e}, {0xa66, 0xa74}, {0xa81, 0xa83}, {0xa85, 0xa8b},
    {0xa8d, 0xa8d}, {0xa8f, 0xa91}, {0xa93, 0xaa8}, {0xaaa, 0xab0},
    {0xab2, 0xab3}, {0xab5, 0xab9}, {0xabc, 0xac5}, {0xac7, 0xac9},
    {0xacb, 0xacd}, {0xae0, 0xae0}, {0xae6, 0xaef}, {0xb01, 0xb03},
    {0xb05, 0xb0c}, {0xb0f, 0xb10}, {0xb13, 0xb28}, {0xb2a, 0xb30},
    {0xb32, 0xb33}, {0xb36, 0xb39}, {0xb3c, 0xb43}, {0xb47, 0xb48},
    {0xb4b, 0xb4d}, {0xb56, 0xb57}, {0xb5c, 0xb5d}, {0xb5f, 0xb61},
    {0xb66, 0xb6f}, {0xb82, 0xb83}, {0xb85, 0xb8a}, {0xb8e, 0xb90},
    {0xb92, 0xb95}, {0xb99, 0xb9a}, {0xb9c, 0xb9c}, {0xb9e, 0xb9f},
    {0xba3, 0xba4}, {0xba8, 0xbaa}, {0xbae, 0xbb5}, {0xbb7, 0xbb9},
    {0xbbe, 0xbc2}, {0xbc6, 0xbc8}, {0xbca, 0xbcd}, {0xbd7, 0xbd7},
    {0xbe7, 0xbef}, {0xc01, 0xc03}, {0xc05, 0xc0c}, {0xc0e, 0xc10},
    {0xc12, 0xc28}, {0xc2a, 0xc33}, {0xc35, 0xc39}, {0xc3e, 0xc44},
    {0xc46, 0xc48}, {0xc4a, 0xc4d}, {0xc55, 0xc56}, {0xc60, 0xc61},
    {0xc66, 0xc6f}, {0xc82, 0xc83}, {0xc85, 0xc8c}, {0xc8e, 0xc90},
    {0xc92, 0xca8}, {0xcaa, 0xcb3}, {0xcb5, 0xcb9}, {0xcbe, 0xcc4},
    {0xcc6, 0xcc8}, {0xcca, 0xccd}, {0xcd5, 0xcd6}, {0xcde, 0xcde},
    {0xce0, 0xce1}, {0xce6, 0xcef}, {0xd02, 0xd03}, {0xd05, 0xd0c},
    {0xd0e, 0xd10}, {0xd12, 0xd28}, {0xd2a, 0xd39}, {0xd3e, 0xd43},
    {0xd46, 0xd48}, {0xd4a, 0xd4d}, {0xd57, 0xd57}, {0xd60, 0xd61},
    {0xd66, 0xd6f}, {0xe01, 0xe2e}, {0xe30, 0xe3a}, {0xe40, 0xe4e},
    {0xe50, 0xe59}, {0xe81, 0xe82}, {0xe84, 0xe84}, {0xe87, 0xe88},
    {0xe8a, 0xe8a}, {0xe8d, 0xe8d}, {0xe94, 0xe97}, {0xe99, 0xe9f},
    {0xea1, 0xea3}, {0xea5, 0xea5}, {0xea7, 0xea7}, {0xeaa, 0xeab},
    {0xead, 0xeae}, {0xeb0, 0xeb9}, {0xebb, 0xebd}, {0xec0, 0xec4},
    {0xec6, 0xec6}, {0xec8, 0xecd}, {0xed0, 0xed9}, {0xf18, 0xf19},
    {0xf20, 0xf29}, {0xf35, 0xf35}, {0xf37, 0xf37}, {0xf39, 0xf39},
    {0xf3e, 0xf47}, {0xf49, 0xf69}, {0xf71, 0xf84}, {0xf86, 0xf8b},
    {0xf90, 0xf95}, {0xf97, 0xf97}, {0xf99, 0xfad}, {0xfb1, 0xfb7},
    {0xfb9, 0xfb9}, {0x10a0, 0x10c5}, {0x10d0, 0x10f6}, {0x1100, 0x1100},
    {0x1102, 0x1103}, {0x1105, 0x1107}, {0x1109, 0x1109}, {0x110b, 0x110c},
    {0x110e, 0x1112}, {0x113c, 0x113c}, {0x113e, 0x113e}, {0x1140, 0x1140},
    {0x114c, 0x114c}, {0x114e, 0x114e}, {0x1150, 0x1150}, {0x1154, 0x1155},
    {0x1159, 0x1159}, {0x115f, 0x1161}, {0x1163, 0x1163}, {0x1165, 0x1165},
    {0x1167, 0x1167}, {0x1169, 0x1169}, {0x116d, 0x116e}, {0x1172, 0x1173},
    {0x1175, 0x1175}, {0x119e, 0x119e}, {0x11a8, 0x11a8}, {0x11ab, 0x11ab},
    {0x11ae, 0x11af}, {0x11b7, 0x11b8}, {0x11ba, 0x11ba}, {0x11bc, 0x11c2},
    {0x11eb, 0x11eb}, {0x11f0, 0x11f0}, {0x11f9, 0x11f9}, {0x1e00, 0x1e9b},
    {0x1ea0, 0x1ef9}, {0x1f00, 0x1f15}, {0x1f18, 0x1f1d}, {0x1f20, 0x1f45},
    {0x1f48, 0x1f4d}, {0x1f50, 0x1f57}, {0x1f59, 0x1f59}, {0x1f5b, 0x1f5b},
    {0x1f5d, 0x1f5d}, {0x1f5f, 0x1f7d}, {0x1f80, 0x1fb4}, {0x1fb6, 0x1fbc},
    {0x1fbe, 0x1fbe}, {0x1fc2, 0x1fc4}, {0x1fc6, 0x1fcc}, {0x1fd0, 0x1fd3},
    {0x1fd6, 0x1fdb}, {0x1fe0, 0x1fec}, {0x1ff2, 0x1ff4}, {0x1ff6, 0x1ffc},
    {0x20d0, 0x20dc}, {0x20e1, 0x20e1}, {0x2126, 0x2126}, {0x212a, 0x212b},
    {0x212e, 0x212e}, {0x2180, 0x2182}, {0x3005, 0x3005}, {0x3007, 0x3007},
    {0x3021, 0x302f}, {0x3031, 0x3035}, {0x3041, 0x3094}, {0x3099, 0x309a},
    {0x309d, 0x309e}, {0x30a1, 0x30fa}, {0x30fc, 0x30fe}, {0x3105, 0x312c},
    {0x4e00, 0x9fa5}, {0xac00, 0xd7a3},
};

// A minimal tag token: name + attributes + open/close/selfclose kind.
struct Tag {
  std::string name;          // namespace-stripped (semantic dispatch)
  std::string raw_name;      // as written (nesting must match exactly)
  std::vector<Attr> attrs;
  std::vector<std::string> raw_attr_names;  // for prefix validation
  std::vector<std::string> declared;        // xmlns:PREFIX on this tag
  std::vector<std::string> declared_uris;   // URIs of those bindings
  bool closing = false;      // </name>
  bool self_closing = false; // <name ... />
};

const char* attr_of(const Tag& t, const char* name) {
  for (const auto& a : t.attrs)
    if (a.name == name) return a.value.c_str();
  return nullptr;
}

std::string local_name(const std::string& qname) {
  size_t c = qname.rfind(':');
  return c == std::string::npos ? qname : qname.substr(c + 1);
}

struct Parser {
  const char* p;
  const char* end;
  const char* doc_start;
  std::string error;
  struct OpenElem {
    std::string raw_name;
    std::vector<std::string> declared;  // xmlns:PREFIX bindings
  };
  std::vector<OpenElem> open_stack;  // open elements, innermost last
  // prefix → stack of bound URIs (innermost last)
  std::unordered_map<std::string, std::vector<std::string>> ns_active;
  bool seen_root = false;
  bool seen_doctype = false;

  explicit Parser(const char* data, size_t len)
      : p(data), end(data + len), doc_start(data) {}

  // True when the document ended well-formed: no error, exactly one
  // root element, and every element closed. Truncated files (the
  // fuzz's biggest silent-acceptance class) fail here.
  bool eof_ok() const {
    return error.empty() && seen_root && open_stack.empty();
  }

  // Advance to the next tag; returns false at EOF or error (check
  // ``error``). Skips comments, CDATA, processing instructions, and
  // doctype declarations; validates the text spans in between
  // (strict entities; nothing but whitespace outside the root).
  bool next_tag(Tag* tag) {
    while (p < end) {
      const char* lt = static_cast<const char*>(memchr(p, '<', end - p));
      if (!check_text(p, lt ? lt : end)) return false;
      if (!lt) { p = end; return false; }
      p = lt + 1;
      if (p >= end) return fail("truncated document");
      if (*p == '?') {  // processing instruction / XML declaration
        const char* pi_lt = p - 1;
        const char* close = strstr_bounded("?>");
        if (!close) return fail("unterminated PI");
        if (!check_pi(p + 1, close, pi_lt == doc_start)) return false;
        p = close + 2;
        continue;
      }
      if (*p == '!') {
        if (end - p >= 3 && p[1] == '-' && p[2] == '-') {  // comment
          const char* close = strstr_bounded("-->");
          if (!close) return fail("unterminated comment");
          p = close + 3;
          continue;
        }
        if (end - p >= 8 && strncmp(p, "![CDATA[", 8) == 0) {
          // CDATA is character data: only legal inside the root.
          if (open_stack.empty()) {
            return fail(seen_root ? "junk after document element"
                                  : "CDATA before document element");
          }
          const char* close = strstr_bounded("]]>");
          if (!close) return fail("unterminated CDATA");
          p = close + 3;
          continue;
        }
        if (end - p >= 8 && strncmp(p, "!DOCTYPE", 8) == 0 &&
            (end - p == 8 || is_space(p[8]))) {
          // one DOCTYPE, in the prolog only (internal subsets with
          // nested '>' are out of scope for GEXF)
          if (seen_root || seen_doctype) return fail("misplaced DOCTYPE");
          seen_doctype = true;
          const char* close =
              static_cast<const char*>(memchr(p, '>', end - p));
          if (!close) return fail("unterminated declaration");
          p = close + 1;
          continue;
        }
        // Anything else after '<!' is corruption — skipping it would
        // silently drop a damaged element (e.g. a byte flip turning
        // '<node .../>' into '<!ode .../>').
        return fail("malformed markup declaration");
      }
      if (!parse_tag(tag)) return false;
      // Well-formedness: closing tags must match the innermost open
      // element; a second root (or any tag after the root closed) is
      // junk after the document element.
      if (tag->closing) {
        if (open_stack.empty() ||
            open_stack.back().raw_name != tag->raw_name) {
          return fail("mismatched closing tag");
        }
        for (const auto& pre : open_stack.back().declared) {
          auto it = ns_active.find(pre);
          it->second.pop_back();
          if (it->second.empty()) ns_active.erase(it);
        }
        open_stack.pop_back();
      } else {
        if (open_stack.empty() && seen_root) {
          return fail("junk after document element");
        }
        seen_root = true;
        if (!tag->self_closing) {
          for (size_t i = 0; i < tag->declared.size(); ++i) {
            ns_active[tag->declared[i]].push_back(tag->declared_uris[i]);
          }
          open_stack.push_back({tag->raw_name, tag->declared});
        }
      }
      return true;
    }
    return false;
  }

 private:
  const char* strstr_bounded(const char* needle) {
    size_t n = strlen(needle);
    for (const char* q = p; q + n <= end; ++q)
      if (memcmp(q, needle, n) == 0) return q;
    return nullptr;
  }

  bool fail(const char* msg) {
    error = msg;
    p = end;
    return false;
  }

  bool fail_str(std::string msg) {
    error = std::move(msg);
    p = end;
    return false;
  }

  // Processing instruction [s, e): target name must be a valid Name,
  // and the reserved target "xml" (any case) is only legal as THE XML
  // DECLARATION — first bytes of the document, with the strict
  // version/encoding/standalone pseudo-attribute grammar expat
  // enforces. Catches duplicated or displaced declarations and
  // corruption inside the declaration itself.
  bool check_pi(const char* s, const char* e, bool at_doc_start) {
    const char* q = s;
    const char* name_start = q;
    while (q < e && is_name_char(*q)) ++q;
    if (!valid_name(name_start, q) ||
        memchr(name_start, ':', q - name_start)) {
      return fail("malformed PI target");
    }
    std::string target(name_start, q - name_start);
    bool is_xml_decl =
        target.size() == 3 && (target[0] == 'x' || target[0] == 'X') &&
        (target[1] == 'm' || target[1] == 'M') &&
        (target[2] == 'l' || target[2] == 'L');
    if (!is_xml_decl) return true;  // ordinary PI: contents are free-form
    if (!at_doc_start || target != "xml") {
      return fail("XML declaration not at start of document");
    }
    // version="1.x" [encoding="..."] [standalone="yes|no"]
    const char* names[3] = {"version", "encoding", "standalone"};
    int next_allowed = 0;
    while (true) {
      const char* before = q;
      while (q < e && is_space(*q)) ++q;
      if (q == e) break;
      if (before == q) return fail("malformed XML declaration");
      const char* a0 = q;
      while (q < e && is_name_char(*q)) ++q;
      std::string an(a0, q - a0);
      int which = -1;
      for (int i = next_allowed; i < 3; ++i) {
        if (an == names[i]) { which = i; break; }
      }
      if (which < 0 || (which > 0 && next_allowed == 0)) {
        return fail("malformed XML declaration");  // wrong name/order
      }
      next_allowed = which + 1;
      while (q < e && is_space(*q)) ++q;
      if (q == e || *q != '=') return fail("malformed XML declaration");
      ++q;
      while (q < e && is_space(*q)) ++q;
      if (q == e || (*q != '"' && *q != '\'')) {
        return fail("malformed XML declaration");
      }
      char quote = *q++;
      const char* v0 = q;
      while (q < e && *q != quote) ++q;
      if (q == e) return fail("malformed XML declaration");
      std::string val(v0, q - v0);
      ++q;
      if (which == 0) {
        if (val.size() < 3 || val.compare(0, 2, "1.") != 0) {
          return fail("malformed XML declaration");
        }
        for (size_t i = 2; i < val.size(); ++i) {
          if (val[i] < '0' || val[i] > '9') {
            return fail("malformed XML declaration");
          }
        }
      } else if (which == 1) {
        if (val.empty()) return fail("malformed XML declaration");
        for (char c : val) {
          if (!((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') ||
                (c >= '0' && c <= '9') || c == '.' || c == '_' ||
                c == '-')) {
            return fail("malformed XML declaration");
          }
        }
      } else if (val != "yes" && val != "no") {
        return fail("malformed XML declaration");
      }
    }
    if (next_allowed == 0) return fail("malformed XML declaration");
    return true;
  }

  // Text between tags: outside the root only whitespace is allowed;
  // inside, entity references must be valid (content itself is
  // discarded — GEXF carries data in attributes).
  bool check_text(const char* s, const char* e) {
    if (open_stack.empty()) {
      for (const char* q = s; q < e; ++q) {
        if (!is_space(*q)) {
          return fail(seen_root ? "junk after document element"
                                : "text before document element");
        }
      }
      return true;
    }
    std::string err;
    if (!decode_entities_strict(s, e - s, nullptr, &err)) {
      return fail_str(err + " in text");
    }
    return true;
  }

  static bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
  }
  // Byte-level span scan for names: ASCII NameChars plus any ≥0x80
  // byte (multi-byte sequences are validated as CODE POINTS by
  // valid_name below — a 10k-mutant soak found expat rejecting
  // non-NameChar Unicode (U+00D7, or the 5th-edition-only U+0132)
  // inside names that a byte-level check waved through).
  static bool is_name_char(char ch) {
    unsigned char c = static_cast<unsigned char>(ch);
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') ||
           (c >= '0' && c <= '9') || c == '-' || c == '.' || c == '_' ||
           c == ':' || c >= 0x80;
  }
  // Name character classes — NOT the XML 1.0 5th-edition ranges: the
  // Python fallback parses through expat, which enforces the FOURTH
  // edition (Unicode-2.0-frozen) Appendix-B tables, and parity with
  // the fallback is the contract (a 10k-mutant soak caught 5th-ed
  // ranges accepting names like "sou\u05F0rce" that expat rejects).
  // The tables below are derived EMPIRICALLY from this build's expat:
  // every BMP code point was probed as <Xx/> (name start) and <aXx/>
  // (name char); no supplementary-plane code point is accepted.
  static bool in_ranges(unsigned cp, const unsigned (*r)[2], int n) {
    int lo = 0, hi = n - 1;
    while (lo <= hi) {
      int mid = (lo + hi) / 2;
      if (cp < r[mid][0]) hi = mid - 1;
      else if (cp > r[mid][1]) lo = mid + 1;
      else return true;
    }
    return false;
  }
  static bool is_name_start_cp(unsigned cp) {
    if (cp < 0x80) {
      return cp == ':' || cp == '_' || (cp >= 'A' && cp <= 'Z') ||
             (cp >= 'a' && cp <= 'z');
    }
    return in_ranges(cp, kNameStartRanges,
                     sizeof(kNameStartRanges) / sizeof(*kNameStartRanges));
  }
  static bool is_name_cp(unsigned cp) {
    if (cp < 0x80) {
      return is_name_start_cp(cp) || cp == '-' || cp == '.' ||
             (cp >= '0' && cp <= '9');
    }
    return in_ranges(cp, kNameCharRanges,
                     sizeof(kNameCharRanges) / sizeof(*kNameCharRanges));
  }
  // Decode one code point; input is valid UTF-8 (document pre-scan).
  static unsigned next_cp(const char*& q) {
    unsigned char c = static_cast<unsigned char>(*q++);
    if (c < 0x80) return c;
    int extra = c >= 0xF0 ? 3 : c >= 0xE0 ? 2 : 1;
    unsigned cp = c & (0x3F >> extra);
    for (int i = 0; i < extra; ++i) {
      cp = (cp << 6) | (static_cast<unsigned char>(*q++) & 0x3F);
    }
    return cp;
  }
  static bool valid_name(const char* s, const char* e) {
    const char* q = s;
    bool first = true;
    while (q < e) {
      unsigned cp = next_cp(q);
      if (first ? !is_name_start_cp(cp) : !is_name_cp(cp)) return false;
      first = false;
    }
    return !first;
  }

  // Namespace validation (the Python fallback parses through expat
  // WITH namespace processing, so this is part of the parity
  // contract): unbound prefixes reject; NCName structure (no second
  // colon, local part starts with a NameStartChar); declarations with
  // empty URIs or reserved prefixes reject; duplicate attributes are
  // detected on EXPANDED (uri, local) names. Bindings declared on THIS
  // tag apply to the whole tag regardless of attribute order.
  static constexpr const char* kXmlUri =
      "http://www.w3.org/XML/1998/namespace";
  static constexpr const char* kXmlnsUri =
      "http://www.w3.org/2000/xmlns/";

  bool check_prefixes(Tag* tag) {
    // collect this tag's declarations (with URI validation)
    for (size_t i = 0; i < tag->raw_attr_names.size(); ++i) {
      const std::string& raw = tag->raw_attr_names[i];
      if (raw == "xmlns") {
        // default-namespace declaration: xmlns="" (undeclaring) is
        // legal, but binding the default to either reserved URI is
        // not — expat (the fallback's parser) rejects both binding
        // the xmlns URI to anything and binding the xml URI to any
        // prefix other than "xml", the default included.
        const std::string& uri = tag->attrs[i].value;
        if (uri == kXmlUri || uri == kXmlnsUri) {
          return fail("reserved namespace binding");
        }
        continue;
      }
      if (raw.compare(0, 6, "xmlns:") == 0) {
        std::string pre = raw.substr(6);
        const std::string& uri = tag->attrs[i].value;
        if (pre.empty() || pre.find(':') != std::string::npos) {
          return fail("malformed xmlns declaration");
        }
        if (uri.empty()) return fail("must not undeclare prefix");
        if (pre == "xmlns") return fail("reserved prefix (xmlns)");
        if (pre == "xml" ? uri != kXmlUri
                         : (uri == kXmlUri || uri == kXmlnsUri)) {
          return fail("reserved namespace binding");
        }
        tag->declared.push_back(pre);
        tag->declared_uris.push_back(uri);
      }
    }
    // prefix → URI under this tag's scope ("" = unbound)
    auto resolve = [&](const std::string& pre) -> std::string {
      if (pre == "xml") return kXmlUri;
      for (size_t i = tag->declared.size(); i-- > 0;) {
        if (tag->declared[i] == pre) return tag->declared_uris[i];
      }
      auto it = ns_active.find(pre);
      if (it != ns_active.end()) return it->second.back();
      return "";
    };
    // split + structural NCName checks; returns false on malformed
    auto split_name = [&](const std::string& raw, std::string* pre,
                          std::string* local) -> bool {
      size_t c = raw.find(':');
      if (c == std::string::npos) {
        *pre = "";
        *local = raw;
        return true;
      }
      *pre = raw.substr(0, c);
      *local = raw.substr(c + 1);
      if (pre->empty() || local->empty() ||
          local->find(':') != std::string::npos) {
        return false;  // ":x", "x:", "a:b:c"
      }
      const char* q = local->data();
      if (!is_name_start_cp(next_cp(q))) return false;  // e.g. "p:9x"
      return true;
    };
    std::string pre, local;
    if (!split_name(tag->raw_name, &pre, &local) ||
        pre == "xmlns" || (!pre.empty() && resolve(pre).empty())) {
      return fail("unbound or malformed namespace prefix");
    }
    // expanded-name duplicate detection (raw duplicates were caught
    // inline during attribute parsing)
    std::vector<std::pair<std::string, std::string>> seen;
    for (const auto& raw : tag->raw_attr_names) {
      if (raw == "xmlns" || raw.compare(0, 6, "xmlns:") == 0) continue;
      if (!split_name(raw, &pre, &local)) {
        return fail("unbound or malformed namespace prefix");
      }
      std::string uri;
      if (!pre.empty()) {
        uri = resolve(pre);
        if (uri.empty()) {
          return fail("unbound or malformed namespace prefix");
        }
      }
      for (const auto& sn : seen) {
        if (sn.first == uri && sn.second == local) {
          return fail("duplicate attribute");
        }
      }
      seen.emplace_back(std::move(uri), std::move(local));
    }
    return true;
  }

  bool parse_tag(Tag* tag) {
    tag->attrs.clear();
    tag->raw_attr_names.clear();
    tag->declared.clear();
    tag->declared_uris.clear();
    tag->closing = tag->self_closing = false;
    if (p < end && *p == '/') {
      tag->closing = true;
      ++p;
    }
    const char* start = p;
    while (p < end && is_name_char(*p)) ++p;
    if (!valid_name(start, p)) return fail("malformed tag name");
    tag->raw_name.assign(start, p - start);
    tag->name = local_name(tag->raw_name);
    // attributes
    while (p < end) {
      while (p < end && is_space(*p)) ++p;
      if (p >= end) return fail("unterminated tag");
      if (*p == '>') {
        ++p;
        return check_prefixes(tag);
      }
      if (*p == '/') {
        if (tag->closing) return fail("malformed closing tag");
        ++p;
        if (p < end && *p == '>') {
          ++p;
          tag->self_closing = true;
          return check_prefixes(tag);
        }
        return fail("stray '/' in tag");
      }
      if (tag->closing) return fail("attribute on closing tag");
      const char* astart = p;
      while (p < end && is_name_char(*p)) ++p;
      if (!valid_name(astart, p)) return fail("malformed attribute name");
      const char* p0 = p;
      std::string aname = local_name(std::string(astart, p - astart));
      while (p < end && is_space(*p)) ++p;
      if (p >= end || *p != '=') return fail("attribute without value");
      ++p;
      while (p < end && is_space(*p)) ++p;
      if (p >= end || (*p != '"' && *p != '\'')) return fail("unquoted attribute");
      char quote = *p++;
      const char* vstart = p;
      const char* vend =
          static_cast<const char*>(memchr(p, quote, end - p));
      if (!vend) return fail("unterminated attribute value");
      if (memchr(vstart, '<', vend - vstart)) {
        return fail("'<' in attribute value");
      }
      p = vend + 1;
      if (p < end && !is_space(*p) && *p != '>' && *p != '/') {
        return fail("missing whitespace between attributes");
      }
      std::string decoded, err;
      if (!decode_entities_strict(vstart, vend - vstart, &decoded, &err)) {
        return fail_str(err + " in attribute value");
      }
      for (const auto& r : tag->raw_attr_names) {
        if (r.size() == static_cast<size_t>(p0 - astart) &&
            memcmp(r.data(), astart, r.size()) == 0) {
          return fail("duplicate attribute");
        }
      }
      tag->raw_attr_names.emplace_back(astart, p0 - astart);
      tag->attrs.push_back({std::move(aname), std::move(decoded)});
    }
    return fail("unterminated tag");
  }
};

struct Gexf {
  std::string nodes_blob;  // id\0label\0type\0 ...
  std::string edges_blob;  // src\0dst\0rel\0 ...
  std::string graph_name;
  long num_nodes = 0;
  long num_edges = 0;
  std::string error;
};

void append3(std::string* blob, const std::string& a, const std::string& b,
             const std::string& c) {
  blob->append(a);
  blob->push_back('\0');
  blob->append(b);
  blob->push_back('\0');
  blob->append(c);
  blob->push_back('\0');
}

}  // namespace

extern "C" {

Gexf* gexf_parse(const char* path) {
  auto* g = new Gexf();
  FILE* f = fopen(path, "rb");
  if (!f) {
    g->error = std::string("cannot open ") + path;
    return g;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data(static_cast<size_t>(size), '\0');
  if (size > 0 && fread(&data[0], 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    g->error = "short read";
    return g;
  }
  fclose(f);

  if (!validate_document(data, &g->error)) return g;

  // A UTF-8 BOM is legal before the XML declaration — skip it so the
  // declaration still counts as "at start of document".
  const char* doc = data.data();
  size_t doc_len = data.size();
  if (doc_len >= 3 && memcmp(doc, "\xEF\xBB\xBF", 3) == 0) {
    doc += 3;
    doc_len -= 3;
  }
  Parser parser(doc, doc_len);
  Tag tag;

  // attribute-id → title maps, per declaration class
  std::unordered_map<std::string, std::string> node_titles, edge_titles;
  std::string cur_attr_class;

  struct EdgeRec {
    std::string src, dst, rel;
  };
  std::vector<EdgeRec> edges;
  std::unordered_map<std::string, size_t> edge_pos;  // "src\0dst" → index

  // current open element being filled (node or edge)
  enum class Open { None, Node, Edge } open = Open::None;
  std::string cur_id, cur_label, cur_type;  // node fields
  bool cur_label_present = false;  // label="" is kept, absent falls back to id
  EdgeRec cur_edge;

  auto flush_node = [&]() {
    append3(&g->nodes_blob, cur_id, cur_label_present ? cur_label : cur_id,
            cur_type);
    ++g->num_nodes;
  };
  auto flush_edge = [&]() {
    std::string key = cur_edge.src + '\0' + cur_edge.dst;
    auto it = edge_pos.find(key);
    if (it == edge_pos.end()) {
      edge_pos.emplace(std::move(key), edges.size());
      edges.push_back(cur_edge);
    } else {
      edges[it->second].rel = cur_edge.rel;  // last relationship wins
    }
  };

  while (parser.next_tag(&tag)) {
    if (!tag.closing) {
      if (tag.name == "graph") {
        const char* nm = attr_of(tag, "name");
        g->graph_name = nm ? nm : "";
      } else if (tag.name == "attributes") {
        const char* cls = attr_of(tag, "class");
        cur_attr_class = cls ? cls : "";
      } else if (tag.name == "attribute" && !cur_attr_class.empty()) {
        const char* id = attr_of(tag, "id");
        const char* title = attr_of(tag, "title");
        auto& titles = cur_attr_class == "node" ? node_titles : edge_titles;
        titles[id ? id : ""] = title ? title : "";
        if (tag.self_closing) continue;
      } else if (tag.name == "node") {
        const char* id = attr_of(tag, "id");
        const char* label = attr_of(tag, "label");
        cur_id = id ? id : "";
        cur_label = label ? label : "";
        cur_label_present = label != nullptr;
        cur_type.clear();
        if (tag.self_closing) {
          flush_node();
        } else {
          open = Open::Node;
        }
      } else if (tag.name == "edge") {
        const char* src = attr_of(tag, "source");
        const char* dst = attr_of(tag, "target");
        const char* label = attr_of(tag, "label");
        cur_edge = {src ? src : "", dst ? dst : "", label ? label : ""};
        if (tag.self_closing) {
          flush_edge();
        } else {
          open = Open::Edge;
        }
      } else if (tag.name == "attvalue") {
        std::string for_id = attr_of(tag, "for") ? attr_of(tag, "for") : "";
        const char* value = attr_of(tag, "value");
        // Undeclared attribute ids fall back to the id itself as the
        // title, and repeated attvalues overwrite (dict semantics) —
        // both matching the Python parser's titles.get(id, id).
        if (open == Open::Node) {
          auto it = node_titles.find(for_id);
          const std::string& title =
              it != node_titles.end() ? it->second : for_id;
          if (title == "node_type") cur_type = value ? value : "";
        } else if (open == Open::Edge) {
          auto it = edge_titles.find(for_id);
          const std::string& title =
              it != edge_titles.end() ? it->second : for_id;
          if (title == "label") cur_edge.rel = value ? value : "";
        }
      }
    } else {  // closing tag
      if (tag.name == "node" && open == Open::Node) {
        flush_node();
        open = Open::None;
      } else if (tag.name == "edge" && open == Open::Edge) {
        flush_edge();
        open = Open::None;
      } else if (tag.name == "attributes") {
        cur_attr_class.clear();
      }
    }
  }

  if (!parser.error.empty()) {
    g->error = parser.error;
    return g;
  }
  if (!parser.eof_ok()) {
    g->error = parser.seen_root
                   ? "truncated document (unclosed elements at EOF)"
                   : "no document element";
    return g;
  }
  for (const auto& e : edges) append3(&g->edges_blob, e.src, e.dst, e.rel);
  g->num_edges = static_cast<long>(edges.size());
  return g;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Encoded view: the native twin of data/encode.encode_hin + infer_schema.
//
// Marshalling strings for millions of nodes/edges costs more than the
// parse itself (measured: the blob→Vertex/Edge path is SLOWER than pure
// Python at 2M nodes), so the hot path never builds per-edge Python
// objects: types and relationships are interned here, edge endpoints
// are resolved to dense per-type indices natively, and Python receives
// int32 COO arrays plus one id\0label\0 blob per node type.
//
// Semantics mirrored exactly (see data/encode.py, data/schema.py):
//   - node types in first-appearance vertex order; per-type node index
//     in document order; duplicate node ids: every occurrence gets an
//     index, LAST occurrence wins for edge resolution (dict overwrite)
//   - relationship signatures inferred from endpoints; mixed signatures
//     rejected; missing endpoints rejected (same messages)
//   - blocks keyed per relationship in first-appearance (deduped) edge
//     order; COO entries in edge order
// ---------------------------------------------------------------------------

struct GexfEncoded {
  std::string type_names_blob;            // type\0 per type
  std::vector<long> type_counts;          // nodes per type
  std::string nodes_blob;                 // per type: id\0label\0 ...
  std::vector<long> node_blob_offsets;    // n_types+1 byte offsets
  std::string rel_names_blob;             // rel\0 per relationship
  std::vector<int> rel_types;             // 2*n_rels: src,dst type idx
  std::vector<long> rel_offsets;          // n_rels+1 entry offsets
  std::vector<int> rows, cols;            // concatenated COO
  std::string error;
};

extern "C" {

GexfEncoded* gexf_encode(Gexf* g) {
  auto* e = new GexfEncoded();
  if (!g->error.empty()) {
    e->error = g->error;
    return e;
  }
  // Walk the nodes blob once: intern types, assign per-type indices.
  std::unordered_map<std::string, int> type_idx;
  std::vector<std::string> type_names;
  std::vector<std::string> per_type_blob;
  // id → (type, within-type index); overwrite = last occurrence wins.
  std::unordered_map<std::string, std::pair<int, int>> node_of;
  node_of.reserve(static_cast<size_t>(g->num_nodes) * 2);
  {
    const char* p = g->nodes_blob.data();
    const char* end = p + g->nodes_blob.size();
    while (p < end) {
      const char* id = p;
      size_t idl = strlen(p);
      p += idl + 1;
      const char* label = p;
      size_t labell = strlen(p);
      p += labell + 1;
      std::string type(p);
      p += type.size() + 1;
      auto it = type_idx.find(type);
      int t;
      if (it == type_idx.end()) {
        t = static_cast<int>(type_names.size());
        type_idx.emplace(type, t);
        type_names.push_back(type);
        per_type_blob.emplace_back();
        e->type_counts.push_back(0);
      } else {
        t = it->second;
      }
      int within = static_cast<int>(e->type_counts[t]++);
      auto& blob = per_type_blob[t];
      blob.append(id, idl);
      blob.push_back('\0');
      blob.append(label, labell);
      blob.push_back('\0');
      node_of[std::string(id, idl)] = {t, within};
    }
  }
  e->node_blob_offsets.push_back(0);
  for (size_t t = 0; t < per_type_blob.size(); ++t) {
    e->nodes_blob += per_type_blob[t];
    e->node_blob_offsets.push_back(static_cast<long>(e->nodes_blob.size()));
    e->type_names_blob += type_names[t];
    e->type_names_blob.push_back('\0');
  }

  // Walk the edges blob: infer relationship signatures, resolve COO.
  std::unordered_map<std::string, int> rel_idx;
  std::vector<std::vector<int>> rel_rows, rel_cols;
  {
    const char* p = g->edges_blob.data();
    const char* end = p + g->edges_blob.size();
    while (p < end) {
      std::string src(p);
      p += src.size() + 1;
      std::string dst(p);
      p += dst.size() + 1;
      std::string rel(p);
      p += rel.size() + 1;
      auto si = node_of.find(src);
      auto di = node_of.find(dst);
      if (si == node_of.end() || di == node_of.end()) {
        e->error = "edge endpoint '" +
                   (si == node_of.end() ? src : dst) +
                   "' has no vertex entry";
        return e;
      }
      auto it = rel_idx.find(rel);
      int r;
      if (it == rel_idx.end()) {
        r = static_cast<int>(rel_rows.size());
        rel_idx.emplace(rel, r);
        rel_rows.emplace_back();
        rel_cols.emplace_back();
        e->rel_names_blob += rel;
        e->rel_names_blob.push_back('\0');
        e->rel_types.push_back(si->second.first);
        e->rel_types.push_back(di->second.first);
      } else {
        r = it->second;
        if (e->rel_types[2 * r] != si->second.first ||
            e->rel_types[2 * r + 1] != di->second.first) {
          e->error = "relationship '" + rel + "' has mixed signatures";
          return e;
        }
      }
      rel_rows[r].push_back(si->second.second);
      rel_cols[r].push_back(di->second.second);
    }
  }
  e->rel_offsets.push_back(0);
  for (size_t r = 0; r < rel_rows.size(); ++r) {
    e->rows.insert(e->rows.end(), rel_rows[r].begin(), rel_rows[r].end());
    e->cols.insert(e->cols.end(), rel_cols[r].begin(), rel_cols[r].end());
    e->rel_offsets.push_back(static_cast<long>(e->rows.size()));
  }
  return e;
}

long genc_num_types(GexfEncoded* e) {
  return static_cast<long>(e->type_counts.size());
}
const char* genc_type_names(GexfEncoded* e, long* len) {
  *len = static_cast<long>(e->type_names_blob.size());
  return e->type_names_blob.data();
}
const long* genc_type_counts(GexfEncoded* e) { return e->type_counts.data(); }
const char* genc_nodes_blob(GexfEncoded* e, long* len) {
  *len = static_cast<long>(e->nodes_blob.size());
  return e->nodes_blob.data();
}
const long* genc_node_offsets(GexfEncoded* e) {
  return e->node_blob_offsets.data();
}
long genc_num_rels(GexfEncoded* e) {
  return static_cast<long>(e->rel_offsets.size()) - 1;
}
const char* genc_rel_names(GexfEncoded* e, long* len) {
  *len = static_cast<long>(e->rel_names_blob.size());
  return e->rel_names_blob.data();
}
const int* genc_rel_types(GexfEncoded* e) { return e->rel_types.data(); }
const long* genc_rel_offsets(GexfEncoded* e) { return e->rel_offsets.data(); }
const int* genc_rows(GexfEncoded* e) { return e->rows.data(); }
const int* genc_cols(GexfEncoded* e) { return e->cols.data(); }
const char* genc_error(GexfEncoded* e) {
  return e->error.empty() ? nullptr : e->error.c_str();
}
void genc_free(GexfEncoded* e) { delete e; }

}  // extern "C"

extern "C" {

long gexf_num_nodes(Gexf* g) { return g->num_nodes; }
long gexf_num_edges(Gexf* g) { return g->num_edges; }

const char* gexf_nodes_blob(Gexf* g, long* len) {
  *len = static_cast<long>(g->nodes_blob.size());
  return g->nodes_blob.data();
}
const char* gexf_edges_blob(Gexf* g, long* len) {
  *len = static_cast<long>(g->edges_blob.size());
  return g->edges_blob.data();
}
const char* gexf_graph_name(Gexf* g) { return g->graph_name.c_str(); }

const char* gexf_error(Gexf* g) {
  return g->error.empty() ? nullptr : g->error.c_str();
}
void gexf_free(Gexf* g) { delete g; }

}  // extern "C"
