// Native WordPiece tokenizer (C ABI, loaded via ctypes).
//
// TPU-native replacement for the reference's HF BertTokenizer Rust/Python
// path (reference run_vqa.py:205; vocab at dataset/bert-base-uncased/
// vocab.txt + added [END]).  The host data pipeline tokenizes every
// caption per epoch (masking re-tokenizes too), so this sits on the hot
// host path during pretraining.
//
// Scope: byte-exact with mvlt_tpu_torch.text.tokenizer.WordPieceTokenizer for
// ASCII input (medical reports are ASCII after cleaning).  The Python
// wrapper (mvlt_tpu_torch/text/native.py) falls back to the pure-Python
// implementation for non-ASCII strings, preserving full parity.
//
// Build: mvlt_tpu_torch/text/native.py compiles it at first use
// (c++ -O2 -std=c++17 -shared -fPIC, with ptb.cc, into build/host/).

#include <cctype>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  int unk_id = 100;  // [UNK]
  bool lower = true;
  int max_chars_per_word = 100;
};

bool is_punct(unsigned char c) {
  // ASCII punctuation ranges, mirroring BasicTokenizer._is_punctuation
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// basic tokenize: lowercase, split on whitespace + punctuation
void basic_tokenize(const Tokenizer& tk, const std::string& text,
                    std::vector<std::string>* out) {
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      out->push_back(cur);
      cur.clear();
    }
  };
  for (unsigned char c : text) {
    if (c == 0) continue;
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      flush();
    } else if (c < 0x20 || c == 0x7f) {
      // other ASCII control chars: DELETED with no word boundary
      // (BasicTokenizer._clean_text semantics — \x0b inside a word
      // does NOT split it)
      continue;
    } else if (is_punct(c)) {
      flush();
      out->push_back(std::string(1, static_cast<char>(c)));
    } else {
      cur.push_back(tk.lower ? static_cast<char>(std::tolower(c))
                             : static_cast<char>(c));
    }
  }
  flush();
}

// greedy longest-match-first WordPiece on one word
void wordpiece(const Tokenizer& tk, const std::string& word,
               std::vector<int>* ids) {
  if (static_cast<int>(word.size()) > tk.max_chars_per_word) {
    ids->push_back(tk.unk_id);
    return;
  }
  std::vector<int> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int cur_id = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = tk.vocab.find(sub);
      if (it != tk.vocab.end()) {
        cur_id = it->second;
        break;
      }
      --end;
    }
    if (cur_id < 0) {
      ids->push_back(tk.unk_id);
      return;
    }
    pieces.push_back(cur_id);
    start = end;
  }
  ids->insert(ids->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* mvlt_tokenizer_create(const char* vocab_path, int do_lower) {
  auto* tk = new Tokenizer();
  tk->lower = do_lower != 0;
  std::ifstream f(vocab_path);
  if (!f.good()) {
    delete tk;
    return nullptr;
  }
  std::string line;
  int idx = 0;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    tk->vocab.emplace(line, idx++);
  }
  auto unk = tk->vocab.find("[UNK]");
  if (unk != tk->vocab.end()) tk->unk_id = unk->second;
  return tk;
}

// Register an extra token (e.g. [END]) appended past the file vocab.
int mvlt_tokenizer_add_token(void* handle, const char* token) {
  auto* tk = static_cast<Tokenizer*>(handle);
  auto it = tk->vocab.find(token);
  if (it != tk->vocab.end()) return it->second;
  int id = static_cast<int>(tk->vocab.size());
  tk->vocab.emplace(token, id);
  return id;
}

int mvlt_tokenizer_vocab_size(void* handle) {
  return static_cast<int>(static_cast<Tokenizer*>(handle)->vocab.size());
}

void mvlt_tokenizer_destroy(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

// Encode text -> ids. Special tokens ([CLS] etc.) survive whole only when
// whitespace-delimited (matching the wrapper's usage). Returns the number
// of ids, or -1 if out buffer is too small.
int mvlt_tokenizer_encode(void* handle, const char* text, int* out,
                          int max_out) {
  auto* tk = static_cast<Tokenizer*>(handle);
  std::vector<int> ids;
  std::string s(text);

  // split on TRUE whitespace only (' ', \t, \n, \r) so bracketed
  // special tokens can be matched; \x0b/\x0c are control chars that
  // basic_tokenize DELETES inside a word (std::isspace would split)
  auto is_ws = [](unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
  };
  size_t i = 0;
  std::vector<std::string> words;
  while (i < s.size()) {
    while (i < s.size() && is_ws(static_cast<unsigned char>(s[i]))) ++i;
    size_t j = i;
    while (j < s.size() && !is_ws(static_cast<unsigned char>(s[j]))) ++j;
    if (j > i) words.push_back(s.substr(i, j - i));
    i = j;
  }
  for (const auto& w : words) {
    if (w.size() >= 3 && w.front() == '[' && w.back() == ']') {
      auto it = tk->vocab.find(w);
      if (it != tk->vocab.end()) {
        ids.push_back(it->second);
        continue;
      }
    }
    std::vector<std::string> basic;
    basic_tokenize(*tk, w, &basic);
    for (const auto& b : basic) wordpiece(*tk, b, &ids);
  }
  if (static_cast<int>(ids.size()) > max_out) return -1;
  std::memcpy(out, ids.data(), ids.size() * sizeof(int));
  return static_cast<int>(ids.size());
}

}  // extern "C"
