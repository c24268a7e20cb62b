// Native streaming FASTA/FASTQ(.gz) reader.
//
// The port's copy of mashmap_tpu/native/fastaread.cpp (host code, no
// device): equivalent of the reference's kseq.h + gzstream.h runtime
// pieces (reference: src/common/kseq.h, src/common/gzstream.h, used via
// seqiter.hpp): zlib-backed buffered record parser with the reference's
// sanitation folded in (uppercase, non-ACGT -> 'N';
// commonFunc.hpp:75-107) so Python receives mapping-ready bytes.
//
// C ABI (ctypes-friendly):
//   void* fr_open(const char* path);
//   int   fr_next(void* h, const char** name, long* name_len,
//                 const char** seq, long* seq_len);   // 1=record, 0=EOF, -1=error
//   void  fr_close(void* h);
// Returned pointers stay valid until the next fr_next/fr_close call.

#include <zlib.h>

#include <cctype>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t kBufSize = 1 << 20;

struct Reader {
  gzFile f = nullptr;
  std::vector<unsigned char> buf;
  size_t pos = 0, len = 0;
  bool eof = false;
  std::string name;
  std::string seq;
  int peeked = -2;  // -2 = none
  char sanitize[256];
};

int rd_getc(Reader* r) {
  if (r->peeked != -2) {
    int c = r->peeked;
    r->peeked = -2;
    return c;
  }
  if (r->pos >= r->len) {
    if (r->eof) return -1;
    int n = gzread(r->f, r->buf.data(), static_cast<unsigned>(r->buf.size()));
    if (n <= 0) {
      r->eof = true;
      return -1;
    }
    r->len = static_cast<size_t>(n);
    r->pos = 0;
  }
  return r->buf[r->pos++];
}

void rd_ungetc(Reader* r, int c) { r->peeked = c; }

// read to end of line into out (optionally); returns false on EOF-before-any
bool rd_line(Reader* r, std::string* out) {
  int c = rd_getc(r);
  if (c < 0) return false;
  while (c >= 0 && c != '\n') {
    if (out && c != '\r') out->push_back(static_cast<char>(c));
    c = rd_getc(r);
  }
  return true;
}

}  // namespace

extern "C" {

void* fr_open(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, kBufSize);
  Reader* r = new Reader();
  r->f = f;
  r->buf.resize(kBufSize);
  // reference sanitation table (commonFunc.hpp:75-107)
  for (int i = 0; i < 256; ++i) r->sanitize[i] = 'N';
  const char* bases = "ACGT";
  for (int i = 0; i < 4; ++i) {
    r->sanitize[static_cast<int>(bases[i])] = bases[i];
    r->sanitize[static_cast<int>(std::tolower(bases[i]))] = bases[i];
  }
  return r;
}

int fr_next(void* h, const char** name, long* name_len, const char** seq,
            long* seq_len) {
  Reader* r = static_cast<Reader*>(h);
  r->name.clear();
  r->seq.clear();

  int c;
  do {
    c = rd_getc(r);
  } while (c == '\n' || c == '\r');
  if (c < 0) return 0;
  if (c != '>' && c != '@') return -1;
  const bool fastq = (c == '@');

  // header: name = text up to first space/tab (seqiter semantics)
  std::string header;
  if (!rd_line(r, &header)) return -1;
  size_t sp = header.find_first_of(" \t");
  r->name = header.substr(0, sp);

  if (!fastq) {
    while ((c = rd_getc(r)) >= 0) {
      if (c == '>') {
        rd_ungetc(r, c);
        break;
      }
      if (c == '\n' || c == '\r') continue;
      r->seq.push_back(r->sanitize[static_cast<unsigned char>(c)]);
      // consume rest of line fast
      while ((c = rd_getc(r)) >= 0 && c != '\n') {
        if (c != '\r')
          r->seq.push_back(r->sanitize[static_cast<unsigned char>(c)]);
      }
    }
  } else {
    // sequence line(s) until '+'
    while ((c = rd_getc(r)) >= 0 && c != '+') {
      if (c == '\n' || c == '\r') continue;
      r->seq.push_back(r->sanitize[static_cast<unsigned char>(c)]);
      while ((c = rd_getc(r)) >= 0 && c != '\n') {
        if (c != '\r')
          r->seq.push_back(r->sanitize[static_cast<unsigned char>(c)]);
      }
    }
    if (c == '+') {
      rd_line(r, nullptr);  // rest of '+' line
      // quality: exactly seq-length non-newline chars
      size_t q = 0;
      while (q < r->seq.size() && (c = rd_getc(r)) >= 0) {
        if (c != '\n' && c != '\r') ++q;
      }
    }
  }

  *name = r->name.c_str();
  *name_len = static_cast<long>(r->name.size());
  *seq = r->seq.data();
  *seq_len = static_cast<long>(r->seq.size());
  return 1;
}

void fr_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (r->f) gzclose(r->f);
  delete r;
}

}  // extern "C"
