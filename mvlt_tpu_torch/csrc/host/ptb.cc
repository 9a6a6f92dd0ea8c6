// Native PTB tokenizer for the metric path (C ABI, ctypes).
//
// The reference shells out to Stanford CoreNLP's Java PTBTokenizer with
// `-preserveLines -lowerCase` and then strips a punctuation list
// (reference pycocoevalcap/tokenizer/ptbtokenizer.py:18-74).  This is the
// framework-owned native equivalent, byte-exact with the Python port in
// mvlt_tpu_torch/metrics/ptb.py (parity-tested in tests/test_torch_native.py).
//
// Build: with tokenizer.cc into one library (mvlt_tpu_torch/text/native.py).

#include <cctype>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

const std::unordered_set<std::string>& punct_set() {
  static const std::unordered_set<std::string> kPunct = {
      "''", "'", "``", "`",
      // case-sensitive, like the reference filter over lowercased
      // output (ptbtokenizer.py:21-22): "-lrb-" etc. are KEPT
      "-LRB-", "-RRB-", "-LCB-", "-RCB-",
      ".", "?", "!", ",", ":", "-", "--", "...", ";"};
  return kPunct;
}

bool is_open_context(char prev) {
  return prev == '\0' || prev == ' ' || prev == '(' || prev == '[' ||
         prev == '{' || prev == '<';
}

// Must stay in sync with ABBREVIATIONS in mvlt_tpu_torch/metrics/ptb.py
// (fixture-parity-tested in tests/test_native.py).
const std::unordered_set<std::string>& abbrev_set() {
  static const std::unordered_set<std::string> kAbbrev = {
      "mr.", "mrs.", "ms.", "dr.", "prof.", "rev.", "gen.", "gov.", "sen.",
      "rep.", "col.", "maj.", "sgt.", "capt.", "lt.", "cmdr.", "adm.",
      "hon.", "jr.", "sr.",
      "inc.", "corp.", "co.", "ltd.", "bros.", "dept.", "univ.",
      "st.", "ave.", "blvd.", "rd.", "mt.", "hwy.",
      "jan.", "feb.", "mar.", "apr.", "jun.", "jul.", "aug.", "sep.",
      "sept.", "oct.", "nov.", "dec.",
      "etc.", "vs.", "cf.", "al.", "viz.", "e.g.", "i.e.", "fig.", "figs.",
      "vol.", "vols.", "approx.",
      "cm.", "mm.", "ml.", "mg.", "kg."};
  return kAbbrev;
}

// ^([A-Za-z]\.)+[A-Za-z]?\.?$  — internal-period acronym ("u.s.", "a.m.")
bool is_acronym(const std::string& w) {
  size_t i = 0;
  size_t pairs = 0;
  while (i + 1 < w.size() && std::isalpha((unsigned char)w[i]) &&
         w[i + 1] == '.') {
    i += 2;
    ++pairs;
  }
  if (pairs == 0) return false;
  if (i == w.size()) return true;
  // duplicated final period after the pairs ('u.s..') — the Python
  // regex's optional trailing \.? accepts it
  if (w[i] == '.' && i + 1 == w.size()) return true;
  if (std::isalpha((unsigned char)w[i])) {
    ++i;
    if (i == w.size()) return true;
    if (w[i] == '.' && i + 1 == w.size()) return true;
  }
  return false;
}

std::string lower(const std::string& s) {
  std::string o = s;
  for (char& c : o) c = (char)std::tolower((unsigned char)c);
  return o;
}

// mirrors _ptb_tokenize_line in mvlt_tpu_torch/metrics/ptb.py
std::string ptb_line(const std::string& text) {
  std::string t;
  t.reserve(text.size() * 2);

  // pass 1: quotes (`` / ''), ellipsis, brackets, standard punctuation
  char prev = '\0';
  for (size_t i = 0; i < text.size(); ++i) {
    char c = text[i];
    if (c == '"') {
      t += is_open_context(prev) ? " `` " : " '' ";
    } else if (c == '.' && i + 2 < text.size() && text[i + 1] == '.' &&
               text[i + 2] == '.') {
      t += " ... ";
      i += 2;
    } else if (c == '(') { t += " -LRB- "; }
    else if (c == ')') { t += " -RRB- "; }
    else if (c == '[') { t += " -LSB- "; }
    else if (c == ']') { t += " -RSB- "; }
    else if (c == '{') { t += " -LCB- "; }
    else if (c == '}') { t += " -RCB- "; }
    else if (std::strchr(";@#$%&?!", c)) {
      t += ' '; t += c; t += ' ';
    } else {
      t += c;
    }
    prev = text[i];
  }

  // pass 2: commas not inside numbers — python: ([^\d]), -> "\1 , " and
  // ,([^\d]) -> " , \1"; both need an adjacent non-digit CHARACTER
  std::string u;
  u.reserve(t.size() * 2);
  for (size_t i = 0; i < t.size(); ++i) {
    char c = t[i];
    if (c == ',') {
      bool split_prev = i > 0 && !std::isdigit((unsigned char)t[i - 1]);
      bool split_next = i + 1 < t.size() &&
                        !std::isdigit((unsigned char)t[i + 1]);
      if (split_prev || split_next) { u += " , "; continue; }
    }
    u += c;
  }

  // pass 3: colons — python: ([^:\d]): -> "\1 : " (needs a preceding
  // char that is neither ':' nor a digit)
  std::string w;
  w.reserve(u.size() * 2);
  for (size_t i = 0; i < u.size(); ++i) {
    char c = u[i];
    if (c == ':' && i > 0 && u[i - 1] != ':' &&
        !std::isdigit((unsigned char)u[i - 1])) {
      w += " : ";
      continue;
    }
    w += c;
  }

  // pass 4: dashes (" - " and "--" -> " -- ")
  std::string d;
  d.reserve(w.size() * 2);
  for (size_t i = 0; i < w.size(); ++i) {
    if (i + 2 < w.size() && w[i] == ' ' && w[i + 1] == '-' && w[i + 2] == ' ') {
      d += " -- ";
      i += 2;
    } else if (w[i] == '-' && i + 1 < w.size() && w[i + 1] == '-') {
      d += " -- ";
      ++i;
    } else {
      d += w[i];
    }
  }

  // pass 5: token-wise sentence-period splitting — a trailing period
  // detaches unless the token is a known abbreviation or an
  // internal-period acronym (mirrors _split_periods in metrics/ptb.py)
  std::string e;
  e.reserve(d.size() * 2);
  {
    std::string tok;
    auto flush_tok = [&]() {
      if (tok.empty()) return;
      bool trailing = tok.size() >= 1 && tok.back() == '.' &&
                      !(tok.size() >= 3 &&
                        tok.compare(tok.size() - 3, 3, "...") == 0);
      if (trailing && !abbrev_set().count(lower(tok)) && !is_acronym(tok)) {
        if (tok.size() > 1) {
          e += tok.substr(0, tok.size() - 1);
          e += ' ';
        }
        e += ". ";
      } else {
        e += tok;
        e += ' ';
      }
      tok.clear();
    };
    for (char c : d) {
      if (std::isspace((unsigned char)c)) flush_tok();
      else tok += c;
    }
    flush_tok();
  }
  // drop the trailing space so the possessive rule below cannot
  // fire at end-of-string (Python's regex needs a FOLLOWING space)
  while (!e.empty() && e.back() == ' ') e.pop_back();

  // pass 6: contractions (n't, 'll, 're, 've, 's, 'm, 'd) + possessive
  std::string f;
  f.reserve(e.size() * 2);
  auto word_boundary = [&](size_t j) {
    return j >= e.size() || !(std::isalnum((unsigned char)e[j]) || e[j] == '_');
  };
  for (size_t i = 0; i < e.size(); ++i) {
    char c = e[i];
    char lc = (char)std::tolower((unsigned char)c);
    if ((lc == 'n') && i + 2 < e.size() + 1 && i + 2 <= e.size() &&
        e[i + 1] == '\'' && i + 2 < e.size() &&
        std::tolower((unsigned char)e[i + 2]) == 't' && word_boundary(i + 3)) {
      f += ' '; f += e.substr(i, 3); i += 2; continue;
    }
    if (c == '\'') {
      if (i + 2 < e.size() && word_boundary(i + 3)) {
        std::string two;
        two += (char)std::tolower((unsigned char)e[i + 1]);
        two += (char)std::tolower((unsigned char)e[i + 2]);
        if (two == "ll" || two == "re" || two == "ve") {
          f += ' '; f += e.substr(i, 3); i += 2; continue;
        }
      }
      if (i + 1 < e.size() && word_boundary(i + 2)) {
        char one = (char)std::tolower((unsigned char)e[i + 1]);
        if (one == 's' || one == 'm' || one == 'd') {
          f += ' '; f += e.substr(i, 2); i += 1; continue;
        }
      }
      // possessive plural: "(\w)' " -> "\1 ' "
      if (i > 0 && (std::isalnum((unsigned char)e[i - 1]) || e[i - 1] == '_')
          && i + 1 < e.size() && e[i + 1] == ' ') {
        f += " ' "; i += 1; continue;
      }
    }
    f += c;
  }

  // lowercase + split + strip punctuation list
  std::string out;
  std::string cur;
  auto flush = [&]() {
    if (cur.empty()) return;
    if (!punct_set().count(cur)) {
      if (!out.empty()) out += ' ';
      out += cur;
    }
    cur.clear();
  };
  for (char c : f) {
    if (std::isspace((unsigned char)c)) {
      flush();
    } else {
      cur += (char)std::tolower((unsigned char)c);
    }
  }
  flush();
  return out;
}

}  // namespace

extern "C" {

// Tokenize one caption; returns length written (excluding NUL), or -1 if
// the output buffer is too small.
int mvlt_ptb_tokenize(const char* text, char* out, int max_out) {
  std::string result = ptb_line(text);
  if ((int)result.size() + 1 > max_out) return -1;
  std::memcpy(out, result.c_str(), result.size() + 1);
  return (int)result.size();
}

}  // extern "C"
