// distel_native — C++ load plane: OWL functional syntax → indexed tensors.
//
// The native rebuild of the reference's load plane (AxiomLoader + Normalizer,
// reference src/knoelab/classification/init/{AxiomLoader,Normalizer}.java):
// tokenize + parse the EL fragment, lower sugar, eliminate ranges, normalize
// to NF1-NF7, intern entities to dense ids, binarize n-ary conjunctions, and
// close the (role,filler) link table under role-chain targets — emitting the
// exact flat int32 arrays distel_tpu.core.engine consumes, with zero Python
// object materialization on the hot path.
//
// Semantics mirror distel_tpu/frontend/normalizer.py + core/indexing.py
// one-for-one (the Python frontend stays the readable reference
// implementation; tests/test_native_loader.py proves closure equivalence).
//
// C ABI at the bottom; Python binds via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>
#include <unordered_map>
#include <unordered_set>
#include <map>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- tokenizer

enum TokKind : uint8_t { T_LPAR, T_RPAR, T_EQ, T_NAME, T_IRI, T_STRING, T_CARET, T_LANG, T_EOF };

struct Tok {
  TokKind kind;
  uint32_t start, end;  // byte span in the input
};

struct Tokenizer {
  const char* s;
  size_t n;
  std::vector<Tok> toks;
  std::string error;

  bool run() {
    size_t p = 0;
    while (p < n) {
      char c = s[p];
      if (c == ' ' || c == '\t' || c == '\n' || c == '\r') { p++; continue; }
      if (c == '#') { while (p < n && s[p] != '\n') p++; continue; }
      if (c == '(') { toks.push_back({T_LPAR, (uint32_t)p, (uint32_t)p + 1}); p++; continue; }
      if (c == ')') { toks.push_back({T_RPAR, (uint32_t)p, (uint32_t)p + 1}); p++; continue; }
      if (c == '=') { toks.push_back({T_EQ, (uint32_t)p, (uint32_t)p + 1}); p++; continue; }
      if (c == '<') {
        size_t q = p + 1;
        while (q < n && s[q] != '>' && s[q] != ' ' && s[q] != '\n') q++;
        if (q >= n || s[q] != '>') { error = "unterminated IRI"; return false; }
        toks.push_back({T_IRI, (uint32_t)p, (uint32_t)q + 1});
        p = q + 1;
        continue;
      }
      if (c == '"') {
        size_t q = p + 1;
        while (q < n && s[q] != '"') { if (s[q] == '\\') q++; q++; }
        if (q >= n) { error = "unterminated string"; return false; }
        toks.push_back({T_STRING, (uint32_t)p, (uint32_t)q + 1});
        p = q + 1;
        continue;
      }
      if (c == '^' && p + 1 < n && s[p + 1] == '^') {
        toks.push_back({T_CARET, (uint32_t)p, (uint32_t)p + 2});
        p += 2;
        continue;
      }
      if (c == '@') {
        size_t q = p + 1;
        while (q < n && (isalnum((unsigned char)s[q]) || s[q] == '-')) q++;
        toks.push_back({T_LANG, (uint32_t)p, (uint32_t)q});
        p = q;
        continue;
      }
      // NAME: any run excluding whitespace and ()="^
      size_t q = p;
      while (q < n) {
        char d = s[q];
        if (d == ' ' || d == '\t' || d == '\n' || d == '\r' || d == '(' ||
            d == ')' || d == '=' || d == '"' || d == '^')
          break;
        q++;
      }
      if (q == p) { error = std::string("unexpected character '") + c + "'"; return false; }
      toks.push_back({T_NAME, (uint32_t)p, (uint32_t)q});
      p = q;
    }
    toks.push_back({T_EOF, (uint32_t)n, (uint32_t)n});
    return true;
  }
};

// ------------------------------------------------------------- expressions

// Expression arena. kind: 0 atom-class, 1 atom-individual, 2 THING,
// 3 NOTHING, 4 SOME(role, filler), 5 AND(kids), 6 UNSUPPORTED.
enum ExprKind : uint8_t { E_CLS, E_IND, E_THING, E_NOTHING, E_SOME, E_AND, E_UNSUP };

struct Expr {
  ExprKind kind;
  int32_t name = -1;           // string id for atoms
  int32_t role = -1;           // role string id for SOME
  int32_t a = -1;              // filler for SOME
  std::vector<int32_t> kids;   // operands for AND
};

struct Interner {
  std::unordered_map<std::string, int32_t> ids;
  std::vector<std::string> names;
  int32_t get(const std::string& s) {
    auto it = ids.find(s);
    if (it != ids.end()) return it->second;
    int32_t id = (int32_t)names.size();
    ids.emplace(s, id);
    names.push_back(s);
    return id;
  }
};

// axiom kinds mirrored from the Python AST
enum AxKind : uint8_t {
  A_SUB, A_EQUIV, A_DISJ, A_SUBROLE, A_EQROLE, A_TRANS, A_REFLEX,
  A_DOMAIN, A_RANGE, A_CLSASSERT, A_ROLEASSERT, A_UNSUP
};

struct Axiom {
  AxKind kind;
  std::vector<int32_t> exprs;   // expr arena ids (classes/individuals)
  std::vector<int32_t> roles;   // role string ids (chain first, sup last)
};

struct Parser {
  const char* src;
  const std::vector<Tok>& toks;
  size_t pos = 0;
  std::string error;

  Interner strings;             // raw IRIs / prefixed names (resolved)
  std::vector<Expr> arena;
  std::vector<Axiom> axioms;
  std::unordered_map<std::string, std::string> prefixes;
  std::unordered_set<std::string> declared_individuals;

  int32_t thing_id, nothing_id;

  Parser(const char* s, const std::vector<Tok>& t) : src(s), toks(t) {
    prefixes["owl:"] = "http://www.w3.org/2002/07/owl#";
    prefixes["rdf:"] = "http://www.w3.org/1999/02/22-rdf-syntax-ns#";
    prefixes["rdfs:"] = "http://www.w3.org/2000/01/rdf-schema#";
    prefixes["xsd:"] = "http://www.w3.org/2001/XMLSchema#";
    thing_id = mk_expr(E_THING);
    nothing_id = mk_expr(E_NOTHING);
  }

  int32_t mk_expr(ExprKind k) {
    arena.push_back(Expr{k});
    return (int32_t)arena.size() - 1;
  }

  std::string text(const Tok& t) const { return std::string(src + t.start, t.end - t.start); }

  const Tok& peek() const { return toks[pos]; }
  const Tok& next() { return toks[pos++]; }
  bool expect(TokKind k) {
    if (toks[pos].kind != k) {
      error = "expected token kind " + std::to_string(k) + " got '" + text(toks[pos]) + "'";
      return false;
    }
    pos++;
    return true;
  }

  std::string resolve(const Tok& t) {
    if (t.kind == T_IRI) return std::string(src + t.start + 1, t.end - t.start - 2);
    std::string name = text(t);
    for (auto& kv : prefixes) {
      const std::string& pfx = kv.first;
      if (name.size() >= pfx.size() && name.compare(0, pfx.size(), pfx) == 0)
        return kv.second + name.substr(pfx.size());
    }
    return name;
  }

  static bool is_thing(const std::string& iri) {
    return iri == "http://www.w3.org/2002/07/owl#Thing" || iri == "owl:Thing" || iri == "Thing";
  }
  static bool is_nothing(const std::string& iri) {
    return iri == "http://www.w3.org/2002/07/owl#Nothing" || iri == "owl:Nothing" || iri == "Nothing";
  }

  int32_t as_class(const std::string& iri) {
    if (is_thing(iri)) return thing_id;
    if (is_nothing(iri)) return nothing_id;
    Expr e;
    e.kind = declared_individuals.count(iri) ? E_IND : E_CLS;
    e.name = strings.get(iri);
    arena.push_back(std::move(e));
    return (int32_t)arena.size() - 1;
  }

  // pre-scan Declaration(NamedIndividual(x)) so individuals are recognized
  void prescan() {
    for (size_t i = 0; i + 4 < toks.size(); i++) {
      if (toks[i].kind == T_NAME && text(toks[i]) == "Declaration" &&
          toks[i + 1].kind == T_LPAR && toks[i + 2].kind == T_NAME &&
          text(toks[i + 2]) == "NamedIndividual" && toks[i + 3].kind == T_LPAR) {
        declared_individuals.insert(resolve(toks[i + 4]));
      }
    }
  }

  bool skip_balanced() {  // consume a balanced (...) starting at LPAR
    int depth = 0;
    do {
      const Tok& t = next();
      if (t.kind == T_EOF) { error = "unexpected EOF in group"; return false; }
      if (t.kind == T_LPAR) depth++;
      else if (t.kind == T_RPAR) depth--;
    } while (depth > 0);
    return true;
  }

  bool consume_group_open() {  // already inside '(' at depth 1; eat to match
    int depth = 1;
    while (depth > 0) {
      const Tok& t = next();
      if (t.kind == T_EOF) { error = "unexpected EOF in group"; return false; }
      if (t.kind == T_LPAR) depth++;
      else if (t.kind == T_RPAR) depth--;
    }
    return true;
  }

  bool skip_annotations() {
    while (peek().kind == T_NAME && text(peek()) == "Annotation") {
      next();
      if (!expect(T_LPAR)) return false;
      pos--;  // skip_balanced expects to start at LPAR
      if (!skip_balanced()) return false;
    }
    return true;
  }

  bool parse_document() {
    prescan();
    while (peek().kind != T_EOF) {
      const Tok& t = peek();
      if (t.kind != T_NAME) { error = "expected construct, got '" + text(t) + "'"; return false; }
      std::string kw = text(t);
      if (kw == "Prefix") {
        next();
        if (!expect(T_LPAR)) return false;
        std::string pfx = text(next());
        if (peek().kind == T_EQ) next();
        else if (!pfx.empty() && pfx.back() == '=') pfx.pop_back();
        const Tok& iri = next();
        if (iri.kind != T_IRI) { error = "expected IRI in Prefix"; return false; }
        prefixes[pfx] = std::string(src + iri.start + 1, iri.end - iri.start - 2);
        if (!expect(T_RPAR)) return false;
      } else if (kw == "Ontology") {
        next();
        if (!expect(T_LPAR)) return false;
        if (peek().kind == T_IRI) { next(); if (peek().kind == T_IRI) next(); }
        while (peek().kind != T_RPAR) {
          if (peek().kind == T_EOF) { error = "unterminated Ontology("; return false; }
          if (!parse_axiom()) return false;
        }
        next();  // rpar
      } else {
        if (!parse_axiom()) return false;
      }
    }
    return true;
  }

  bool parse_axiom() {
    const Tok& t = next();
    if (t.kind != T_NAME) { error = "expected axiom, got '" + text(t) + "'"; return false; }
    std::string kw = text(t);
    if (!expect(T_LPAR)) return false;
    if (!skip_annotations()) return false;

    if (kw == "Declaration" || kw == "AnnotationAssertion" ||
        kw == "SubAnnotationPropertyOf" || kw == "AnnotationPropertyDomain" ||
        kw == "AnnotationPropertyRange") {
      return consume_group_open();
    }

    Axiom ax;
    if (kw == "SubClassOf") {
      ax.kind = A_SUB;
      int32_t a = parse_class_expr(); if (a < 0) return false;
      int32_t b = parse_class_expr(); if (b < 0) return false;
      ax.exprs = {a, b};
    } else if (kw == "EquivalentClasses" || kw == "DisjointClasses") {
      ax.kind = kw[0] == 'E' ? A_EQUIV : A_DISJ;
      while (peek().kind != T_RPAR) {
        int32_t e = parse_class_expr(); if (e < 0) return false;
        ax.exprs.push_back(e);
      }
    } else if (kw == "SubObjectPropertyOf") {
      ax.kind = A_SUBROLE;
      if (peek().kind == T_NAME && text(peek()) == "ObjectPropertyChain") {
        next();
        if (!expect(T_LPAR)) return false;
        while (peek().kind != T_RPAR) {
          int32_t r = parse_role(); if (r < 0) return false;
          ax.roles.push_back(r);
        }
        next();
      } else {
        int32_t r = parse_role(); if (r < 0) return false;
        ax.roles.push_back(r);
      }
      int32_t sup = parse_role(); if (sup < 0) return false;
      ax.roles.push_back(sup);
    } else if (kw == "EquivalentObjectProperties") {
      ax.kind = A_EQROLE;
      while (peek().kind != T_RPAR) {
        int32_t r = parse_role(); if (r < 0) return false;
        ax.roles.push_back(r);
      }
    } else if (kw == "TransitiveObjectProperty" || kw == "ReflexiveObjectProperty") {
      ax.kind = kw[0] == 'T' ? A_TRANS : A_REFLEX;
      int32_t r = parse_role(); if (r < 0) return false;
      ax.roles.push_back(r);
    } else if (kw == "ObjectPropertyDomain" || kw == "ObjectPropertyRange") {
      ax.kind = kw[14] == 'D' ? A_DOMAIN : A_RANGE;
      int32_t r = parse_role(); if (r < 0) return false;
      ax.roles.push_back(r);
      int32_t e = parse_class_expr(); if (e < 0) return false;
      ax.exprs.push_back(e);
    } else if (kw == "ClassAssertion") {
      ax.kind = A_CLSASSERT;
      int32_t e = parse_class_expr(); if (e < 0) return false;
      int32_t i = parse_individual(); if (i < 0) return false;
      ax.exprs = {e, i};
    } else if (kw == "ObjectPropertyAssertion") {
      ax.kind = A_ROLEASSERT;
      int32_t r = parse_role(); if (r < 0) return false;
      ax.roles.push_back(r);
      int32_t a = parse_individual(); if (a < 0) return false;
      int32_t b = parse_individual(); if (b < 0) return false;
      ax.exprs = {a, b};
    } else {
      // out-of-profile axiom: record kind, swallow the group
      ax.kind = A_UNSUP;
      ax.roles.push_back(strings.get(kw));  // stash the constructor name
      axioms.push_back(std::move(ax));
      return consume_group_open();
    }
    axioms.push_back(std::move(ax));
    return expect(T_RPAR);
  }

  int32_t parse_class_expr() {
    const Tok& t = next();
    if (t.kind == T_IRI) return as_class(resolve(t));
    if (t.kind != T_NAME) { error = "expected class expression, got '" + text(t) + "'"; return -1; }
    std::string name = text(t);
    bool ctor_like = name.rfind("Object", 0) == 0 || name.rfind("Data", 0) == 0;
    if (peek().kind == T_LPAR && ctor_like) {
      next();  // consume (
      if (name == "ObjectIntersectionOf") {
        Expr e;
        e.kind = E_AND;
        while (peek().kind != T_RPAR) {
          int32_t k = parse_class_expr(); if (k < 0) return -1;
          e.kids.push_back(k);
        }
        next();
        if (e.kids.size() == 1) return e.kids[0];
        arena.push_back(std::move(e));
        return (int32_t)arena.size() - 1;
      }
      if (name == "ObjectSomeValuesFrom") {
        int32_t r = parse_role(); if (r < 0) return -1;
        int32_t f = parse_class_expr(); if (f < 0) return -1;
        Expr e;
        e.kind = E_SOME;
        e.role = r;
        e.a = f;
        arena.push_back(std::move(e));
        int32_t id = (int32_t)arena.size() - 1;
        if (!expect(T_RPAR)) return -1;
        return id;
      }
      if (name == "ObjectOneOf") {
        std::vector<int32_t> inds;
        while (peek().kind != T_RPAR) {
          int32_t i = parse_individual(); if (i < 0) return -1;
          inds.push_back(i);
        }
        next();
        if (inds.size() == 1) return inds[0];
        return mk_expr(E_UNSUP);  // multi-nominal: out of profile
      }
      if (name == "ObjectHasValue") {
        // EL sugar: ObjectHasValue(r a) == ObjectSomeValuesFrom(r {a})
        // (reference loads it as a T3_1 axiom keyed on the individual,
        // init/AxiomLoader.java:702-711)
        int32_t r = parse_role(); if (r < 0) return -1;
        int32_t i = parse_individual(); if (i < 0) return -1;
        Expr e;
        e.kind = E_SOME;
        e.role = r;
        e.a = i;
        arena.push_back(std::move(e));
        int32_t id = (int32_t)arena.size() - 1;
        if (!expect(T_RPAR)) return -1;
        return id;
      }
      if (name == "DataSomeValuesFrom") {
        // datatypes-as-classes (reference EntityType.DATATYPE,
        // init/AxiomLoader.java:687-701): data property as role, named
        // datatype as class; complex data ranges stay out of profile
        int32_t r = parse_role(); if (r < 0) return -1;
        if (peek().kind == T_NAME || peek().kind == T_IRI) {
          Tok dt = next();
          if (peek().kind == T_RPAR) {
            next();
            Expr e;
            e.kind = E_SOME;
            e.role = r;
            e.a = as_class(resolve(dt));
            arena.push_back(std::move(e));
            return (int32_t)arena.size() - 1;
          }
        }
        if (!consume_group_open()) return -1;
        return mk_expr(E_UNSUP);
      }
      if (name == "DataHasValue") {
        // keyed on the literal's datatype (init/AxiomLoader.java:712-721);
        // untyped literals default to xsd:string
        int32_t r = parse_role(); if (r < 0) return -1;
        if (peek().kind == T_STRING) {
          next();
          std::string dt_iri = "http://www.w3.org/2001/XMLSchema#string";
          if (peek().kind == T_LANG) {
            next();
            dt_iri = "http://www.w3.org/1999/02/22-rdf-syntax-ns#PlainLiteral";
          }
          else if (peek().kind == T_CARET) {
            next();
            Tok dt = next();
            if (dt.kind != T_NAME && dt.kind != T_IRI) {
              error = "expected datatype after ^^"; return -1;
            }
            dt_iri = resolve(dt);
          }
          if (peek().kind == T_RPAR) {
            next();
            Expr e;
            e.kind = E_SOME;
            e.role = r;
            e.a = as_class(dt_iri);
            arena.push_back(std::move(e));
            return (int32_t)arena.size() - 1;
          }
        }
        if (!consume_group_open()) return -1;
        return mk_expr(E_UNSUP);
      }
      // unsupported constructor: swallow group
      if (!consume_group_open()) return -1;
      return mk_expr(E_UNSUP);
    }
    return as_class(resolve(t));
  }

  int32_t parse_role() {
    const Tok& t = next();
    if (t.kind == T_NAME && text(t) == "ObjectInverseOf") {
      if (!expect(T_LPAR)) return -1;
      int32_t inner = parse_role(); if (inner < 0) return -1;
      if (!expect(T_RPAR)) return -1;
      return strings.get("__inverse__:" + strings.names[inner]);
    }
    if (t.kind != T_NAME && t.kind != T_IRI) { error = "expected role, got '" + text(t) + "'"; return -1; }
    return strings.get(resolve(t));
  }

  int32_t parse_individual() {
    const Tok& t = next();
    if (t.kind != T_NAME && t.kind != T_IRI) { error = "expected individual"; return -1; }
    std::string iri = resolve(t);
    declared_individuals.insert(iri);
    Expr e;
    e.kind = E_IND;
    e.name = strings.get(iri);
    arena.push_back(std::move(e));
    return (int32_t)arena.size() - 1;
  }
};

// -------------------------------------------------------------- normalizer

// Mirrors distel_tpu/frontend/normalizer.py + core/indexing.py.  Atoms are
// interned straight to engine concept ids (⊥=0, ⊤=1); NF rows are emitted
// as ints; n-ary conjunctions binarize through shared aux concepts.

struct Normalizer {
  Parser& P;

  // concept/role interning (engine ids)
  std::unordered_map<std::string, int32_t> concept_ids;
  std::vector<std::string> concept_names;
  std::unordered_map<std::string, int32_t> role_ids;
  std::vector<std::string> role_names;

  std::vector<int32_t> nf1, nf2, nf3, nf4, nf5, nf6;  // flat rows
  std::vector<int32_t> links;                          // (role, filler)
  std::unordered_map<int64_t, int32_t> link_ids;
  std::vector<int32_t> chain_pairs;                    // (r_first, l2, lt)

  std::unordered_map<std::string, int32_t> memo;       // canon+dir → gensym concept id
  std::unordered_map<std::string, int32_t> range_memo;
  std::unordered_map<int64_t, int32_t> aux_memo;       // binarization
  int64_t gensym_counter = 0;

  // ranges: role string id → set of atom concept ids (collected pass 1)
  std::unordered_map<int32_t, std::vector<int32_t>> ranges_by_role;
  std::vector<std::pair<int32_t, int32_t>> role_edges_str;  // (sub,sup) string ids
  std::unordered_map<int32_t, std::vector<int32_t>> super_closure_str;

  std::map<std::string, int64_t> removed;
  std::vector<std::string> canon_cache;  // per-expr canonical string

  explicit Normalizer(Parser& p) : P(p) {
    concept_ids["owl:Nothing"] = 0; concept_names.push_back("owl:Nothing");
    concept_ids["owl:Thing"] = 1;   concept_names.push_back("owl:Thing");
    canon_cache.assign(P.arena.size(), std::string());
  }

  int32_t concept_of(const std::string& name) {
    auto it = concept_ids.find(name);
    if (it != concept_ids.end()) return it->second;
    int32_t id = (int32_t)concept_names.size();
    concept_ids.emplace(name, id);
    concept_names.push_back(name);
    return id;
  }

  int32_t role_of_str(int32_t string_id) {
    const std::string& iri = P.strings.names[string_id];
    auto it = role_ids.find(iri);
    if (it != role_ids.end()) return it->second;
    int32_t id = (int32_t)role_names.size();
    role_ids.emplace(iri, id);
    role_names.push_back(iri);
    return id;
  }

  int32_t atom_concept(const Expr& e) {
    switch (e.kind) {
      case E_THING: return 1;
      case E_NOTHING: return 0;
      case E_IND: return concept_of("ind:" + P.strings.names[e.name]);
      default: return concept_of(P.strings.names[e.name]);
    }
  }

  // canonical string for memo keys (matches role of expr_to_str in Python)
  const std::string& canon(int32_t eid) {
    std::string& c = canon_cache[eid];
    if (!c.empty()) return c;
    const Expr& e = P.arena[eid];
    switch (e.kind) {
      case E_CLS: c = P.strings.names[e.name]; break;
      case E_IND: c = "ind:" + P.strings.names[e.name]; break;
      case E_THING: c = "owl:Thing"; break;
      case E_NOTHING: c = "owl:Nothing"; break;
      case E_SOME:
        c = "Some(" + P.strings.names[e.role] + "," + canon(e.a) + ")";
        break;
      case E_AND: {
        std::vector<std::string> parts;
        for (int32_t k : e.kids) parts.push_back(canon(k));
        std::sort(parts.begin(), parts.end());
        c = "And(";
        for (size_t i = 0; i < parts.size(); i++) { if (i) c += ","; c += parts[i]; }
        c += ")";
        break;
      }
      case E_UNSUP: c = "UNSUP#" + std::to_string(eid); break;
    }
    return c;
  }

  bool profile_ok(int32_t eid) {
    const Expr& e = P.arena[eid];
    switch (e.kind) {
      case E_UNSUP: return false;
      case E_AND:
        for (int32_t k : e.kids) if (!profile_ok(k)) return false;
        return true;
      case E_SOME: {
        const std::string& r = P.strings.names[e.role];
        if (r.rfind("__inverse__:", 0) == 0) return false;
        return profile_ok(e.a);
      }
      default: return true;
    }
  }

  bool is_atomic(const Expr& e) { return e.kind == E_CLS || e.kind == E_IND; }
  bool atom_or_top(const Expr& e) { return is_atomic(e) || e.kind == E_THING; }
  bool atom_or_bot(const Expr& e) { return is_atomic(e) || e.kind == E_NOTHING; }

  bool lhs_unsat(int32_t eid) {
    const Expr& e = P.arena[eid];
    if (e.kind == E_NOTHING) return true;
    if (e.kind == E_AND) {
      for (int32_t k : e.kids) if (lhs_unsat(k)) return true;
      return false;
    }
    if (e.kind == E_SOME) return lhs_unsat(e.a);
    return false;
  }

  int32_t gensym() {
    std::string name = "distel:gensym#" + std::to_string(gensym_counter++);
    return concept_of(name);
  }

  // ---- pass 1: ranges + plain role hierarchy over string ids
  void pass1() {
    for (auto& ax : P.axioms) {
      if (ax.kind == A_RANGE) {
        int32_t eid = ax.exprs[0];
        if (!profile_ok(eid)) { removed["ObjectPropertyRange"]++; continue; }
        const Expr& e = P.arena[eid];
        int32_t cid;
        if (atom_or_top(e)) cid = atom_concept(e);
        else cid = flatten_rhs(eid);
        ranges_by_role[ax.roles[0]].push_back(cid);
      } else if (ax.kind == A_SUBROLE && ax.roles.size() == 2) {
        role_edges_str.push_back({ax.roles[0], ax.roles[1]});
      } else if (ax.kind == A_EQROLE) {
        size_t n = ax.roles.size();
        for (size_t i = 0; i < n; i++)
          role_edges_str.push_back({ax.roles[i], ax.roles[(i + 1) % n]});
      }
    }
    // reflexive-transitive closure (string-id space; role count is small)
    std::unordered_map<int32_t, std::vector<int32_t>> adj;
    for (auto& e : role_edges_str) { adj[e.first].push_back(e.second); adj[e.second]; }
    for (auto& kv : adj) {
      std::vector<int32_t> seen = {kv.first};
      std::unordered_set<int32_t> in_seen = {kv.first};
      std::vector<int32_t> stack = {kv.first};
      while (!stack.empty()) {
        int32_t cur = stack.back(); stack.pop_back();
        auto it = adj.find(cur);
        if (it == adj.end()) continue;
        for (int32_t nxt : it->second)
          if (in_seen.insert(nxt).second) { seen.push_back(nxt); stack.push_back(nxt); }
      }
      super_closure_str[kv.first] = std::move(seen);
    }
  }

  // ---- normalization core (mirrors _emit_sub / _flatten_lhs / _flatten_rhs)

  int32_t flatten_lhs(int32_t eid) {
    std::string key = canon(eid) + "\x01L";
    auto it = memo.find(key);
    if (it != memo.end()) return it->second;
    int32_t a = gensym();
    memo.emplace(std::move(key), a);
    emit_sub_atomrhs(eid, a);
    return a;
  }

  int32_t flatten_rhs(int32_t eid) {
    std::string key = canon(eid) + "\x01R";
    auto it = memo.find(key);
    if (it != memo.end()) return it->second;
    int32_t a = gensym();
    memo.emplace(std::move(key), a);
    emit_sub_atomlhs(a, eid);
    return a;
  }

  int32_t apply_range_rewrite(int32_t role_str, int32_t b_concept) {
    std::vector<int32_t> rr;
    auto scl = super_closure_str.find(role_str);
    if (scl != super_closure_str.end()) {
      for (int32_t sup : scl->second) {
        auto rit = ranges_by_role.find(sup);
        if (rit != ranges_by_role.end())
          rr.insert(rr.end(), rit->second.begin(), rit->second.end());
      }
    } else {
      auto rit = ranges_by_role.find(role_str);
      if (rit != ranges_by_role.end()) rr = rit->second;
    }
    std::sort(rr.begin(), rr.end());
    rr.erase(std::unique(rr.begin(), rr.end()), rr.end());
    rr.erase(std::remove(rr.begin(), rr.end(), (int32_t)1), rr.end());  // drop ⊤
    rr.erase(std::remove(rr.begin(), rr.end(), b_concept), rr.end());
    if (rr.empty()) return b_concept;
    std::string key = std::to_string(b_concept);
    for (int32_t d : rr) key += "," + std::to_string(d);
    auto it = range_memo.find(key);
    if (it != range_memo.end()) return it->second;
    int32_t x = gensym();
    range_memo.emplace(std::move(key), x);
    if (b_concept != 1) { nf1.push_back(x); nf1.push_back(b_concept); }
    for (int32_t d : rr) { nf1.push_back(x); nf1.push_back(d); }
    return x;
  }

  int32_t link_of(int32_t role_engine, int32_t filler) {
    int64_t key = ((int64_t)role_engine << 32) | (uint32_t)filler;
    auto it = link_ids.find(key);
    if (it != link_ids.end()) return it->second;
    int32_t id = (int32_t)(links.size() / 2);
    link_ids.emplace(key, id);
    links.push_back(role_engine);
    links.push_back(filler);
    return id;
  }

  int32_t aux_concept(int32_t a, int32_t b) {
    int64_t key = a <= b ? ((int64_t)a << 32) | (uint32_t)b
                         : ((int64_t)b << 32) | (uint32_t)a;
    auto it = aux_memo.find(key);
    if (it != aux_memo.end()) return it->second;
    int32_t id = concept_of("distel:aux#" + std::to_string(gensym_counter++));
    aux_memo.emplace(key, id);
    return id;
  }

  // C ⊑ d (d already an atomic concept id)
  void emit_sub_atomrhs(int32_t c_eid, int32_t d_concept) {
    const Expr& c = P.arena[c_eid];
    if (lhs_unsat(c_eid)) return;
    if (atom_or_top(c)) {
      if (d_concept == 1) return;  // ⊑ ⊤ trivial
      nf1.push_back(atom_concept(c));
      nf1.push_back(d_concept);
      return;
    }
    if (c.kind == E_AND) {
      std::vector<int32_t> ops;
      std::unordered_set<std::string> seen;
      for (int32_t k : c.kids) {
        const Expr& ke = P.arena[k];
        if (ke.kind == E_THING) continue;
        if (!seen.insert(canon(k)).second) continue;
        ops.push_back(is_atomic(ke) ? atom_concept(ke) : flatten_lhs(k));
      }
      if (ops.empty()) {
        if (d_concept != 1) { nf1.push_back(1); nf1.push_back(d_concept); }
      } else if (ops.size() == 1) {
        if (d_concept != 1) { nf1.push_back(ops[0]); nf1.push_back(d_concept); }
      } else {
        // binarize left-fold through shared aux concepts
        int32_t acc = ops[0];
        for (size_t i = 1; i + 1 < ops.size(); i++) {
          int32_t aux = aux_concept(acc, ops[i]);
          nf2.push_back(acc); nf2.push_back(ops[i]); nf2.push_back(aux);
          acc = aux;
        }
        nf2.push_back(acc); nf2.push_back(ops.back()); nf2.push_back(d_concept);
      }
      return;
    }
    if (c.kind == E_SOME) {
      const Expr& f = P.arena[c.a];
      int32_t a = atom_or_top(f) ? atom_concept_or_top(c.a) : flatten_lhs(c.a);
      nf4.push_back(role_of_str(c.role));
      nf4.push_back(a);
      nf4.push_back(d_concept);
      return;
    }
  }

  int32_t atom_concept_or_top(int32_t eid) {
    const Expr& e = P.arena[eid];
    if (e.kind == E_THING) return 1;
    return atom_concept(e);
  }

  // a ⊑ D (a already an atomic concept id)
  void emit_sub_atomlhs(int32_t a_concept, int32_t d_eid) {
    const Expr& d = P.arena[d_eid];
    if (d.kind == E_THING) return;
    if (d.kind == E_AND) {
      for (int32_t k : d.kids) emit_sub_atomlhs(a_concept, k);
      return;
    }
    if (atom_or_bot(d)) {
      nf1.push_back(a_concept);
      nf1.push_back(atom_concept(d));
      return;
    }
    if (d.kind == E_SOME) {
      const Expr& f = P.arena[d.a];
      if (f.kind == E_NOTHING) {  // a ⊑ ∃r.⊥ ⟹ a ⊑ ⊥
        nf1.push_back(a_concept);
        nf1.push_back(0);
        return;
      }
      int32_t b = atom_or_top(f) ? atom_concept_or_top(d.a) : flatten_rhs(d.a);
      b = apply_range_rewrite(d.role, b);
      nf3.push_back(a_concept);
      nf3.push_back(link_of(role_of_str(d.role), b));
      return;
    }
  }

  // general C ⊑ D
  void emit_sub(int32_t c_eid, int32_t d_eid) {
    const Expr& c = P.arena[c_eid];
    const Expr& d = P.arena[d_eid];
    if (c.kind == E_NOTHING || d.kind == E_THING) return;
    if (lhs_unsat(c_eid)) return;
    if (d.kind == E_AND) {
      for (int32_t k : d.kids) emit_sub(c_eid, k);
      return;
    }
    if (!atom_or_top(c) && !atom_or_bot(d)) {
      int32_t a = flatten_lhs(c_eid);
      emit_sub_atomlhs(a, d_eid);
      return;
    }
    if (atom_or_top(c)) {
      if (atom_or_bot(d)) {
        if (c.kind == E_THING) { nf1.push_back(1); nf1.push_back(atom_concept(d)); }
        else { nf1.push_back(atom_concept(c)); nf1.push_back(atom_concept(d)); }
      } else {
        emit_sub_atomlhs(atom_concept_or_top(c_eid), d_eid);
      }
      return;
    }
    // C complex, D atomic/⊥
    emit_sub_atomrhs(c_eid, atom_concept(d));
  }

  void lower() {
    for (auto& ax : P.axioms) {
      switch (ax.kind) {
        case A_SUB:
          if (profile_ok(ax.exprs[0]) && profile_ok(ax.exprs[1]))
            emit_sub(ax.exprs[0], ax.exprs[1]);
          else removed["SubClassOf(non-EL)"]++;
          break;
        case A_EQUIV: {
          bool ok = true;
          for (int32_t e : ax.exprs) ok = ok && profile_ok(e);
          if (!ok) { removed["EquivalentClasses(non-EL)"]++; break; }
          size_t n = ax.exprs.size();
          for (size_t i = 0; i < n; i++) emit_sub(ax.exprs[i], ax.exprs[(i + 1) % n]);
          break;
        }
        case A_DISJ: {
          bool ok = true;
          for (int32_t e : ax.exprs) ok = ok && profile_ok(e);
          if (!ok) { removed["DisjointClasses(non-EL)"]++; break; }
          for (size_t i = 0; i < ax.exprs.size(); i++)
            for (size_t j = i + 1; j < ax.exprs.size(); j++) {
              // Ci ⊓ Cj ⊑ ⊥
              const Expr& ei = P.arena[ax.exprs[i]];
              const Expr& ej = P.arena[ax.exprs[j]];
              if (lhs_unsat(ax.exprs[i]) || lhs_unsat(ax.exprs[j])) continue;
              int32_t a = is_atomic(ei) ? atom_concept(ei)
                        : (ei.kind == E_THING ? 1 : flatten_lhs(ax.exprs[i]));
              int32_t b = is_atomic(ej) ? atom_concept(ej)
                        : (ej.kind == E_THING ? 1 : flatten_lhs(ax.exprs[j]));
              if (a == b) { nf1.push_back(a); nf1.push_back(0); continue; }
              nf2.push_back(a); nf2.push_back(b); nf2.push_back(0);
            }
          break;
        }
        case A_SUBROLE: {
          bool inv = false;
          for (int32_t r : ax.roles)
            if (P.strings.names[r].rfind("__inverse__:", 0) == 0) inv = true;
          if (inv) { removed["SubObjectPropertyOf(inverse)"]++; break; }
          size_t n = ax.roles.size();  // chain..., sup
          if (n == 2) {
            nf5.push_back(role_of_str(ax.roles[0]));
            nf5.push_back(role_of_str(ax.roles[1]));
          } else if (n == 3) {
            nf6.push_back(role_of_str(ax.roles[0]));
            nf6.push_back(role_of_str(ax.roles[1]));
            nf6.push_back(role_of_str(ax.roles[2]));
          } else {
            // left-associative split with fresh roles
            int32_t acc = role_of_str(ax.roles[0]);
            for (size_t i = 1; i + 1 < n - 1; i++) {
              std::string nm = "distel:genrole#" + std::to_string(gensym_counter++);
              int32_t u;
              {
                auto it = role_ids.find(nm);
                if (it != role_ids.end()) u = it->second;
                else {
                  u = (int32_t)role_names.size();
                  role_ids.emplace(nm, u);
                  role_names.push_back(nm);
                }
              }
              nf6.push_back(acc); nf6.push_back(role_of_str(ax.roles[i])); nf6.push_back(u);
              acc = u;
            }
            nf6.push_back(acc);
            nf6.push_back(role_of_str(ax.roles[n - 2]));
            nf6.push_back(role_of_str(ax.roles[n - 1]));
          }
          break;
        }
        case A_EQROLE: {
          size_t n = ax.roles.size();
          for (size_t i = 0; i < n; i++) {
            nf5.push_back(role_of_str(ax.roles[i]));
            nf5.push_back(role_of_str(ax.roles[(i + 1) % n]));
          }
          break;
        }
        case A_TRANS: {
          int32_t r = role_of_str(ax.roles[0]);
          nf6.push_back(r); nf6.push_back(r); nf6.push_back(r);
          break;
        }
        case A_REFLEX: removed["ReflexiveObjectProperty"]++; break;
        case A_DOMAIN: {
          if (!profile_ok(ax.exprs[0])) { removed["ObjectPropertyDomain(non-EL)"]++; break; }
          // ∃r.⊤ ⊑ D
          const Expr& d = P.arena[ax.exprs[0]];
          int32_t dc;
          if (atom_or_bot(d)) dc = atom_concept(d);
          else if (d.kind == E_THING) break;
          else dc = flatten_rhs(ax.exprs[0]);
          // note: complex domains D̂ need ∃r.⊤ ⊑ A with A ⊑ D̂
          nf4.push_back(role_of_str(ax.roles[0]));
          nf4.push_back(1);
          nf4.push_back(dc);
          break;
        }
        case A_RANGE: break;  // pass 1
        case A_CLSASSERT: {
          if (!profile_ok(ax.exprs[0])) { removed["ClassAssertion(non-EL)"]++; break; }
          int32_t ind = atom_concept(P.arena[ax.exprs[1]]);
          emit_sub_atomlhs(ind, ax.exprs[0]);
          break;
        }
        case A_ROLEASSERT: {
          int32_t subj = atom_concept(P.arena[ax.exprs[0]]);
          int32_t obj = atom_concept(P.arena[ax.exprs[1]]);
          int32_t b = apply_range_rewrite(ax.roles[0], obj);
          nf3.push_back(subj);
          nf3.push_back(link_of(role_of_str(ax.roles[0]), b));
          break;
        }
        case A_UNSUP:
          removed[P.strings.names[ax.roles[0]]]++;
          break;
      }
    }
  }

  // role closure over engine role ids (Warshall; Nr small) + link chain closure
  std::vector<uint8_t> role_closure;

  void finish() {
    int32_t nr = std::max<int32_t>((int32_t)role_names.size(), 1);
    role_closure.assign((size_t)nr * nr, 0);
    for (int32_t i = 0; i < nr; i++) role_closure[(size_t)i * nr + i] = 1;
    for (size_t i = 0; i + 1 < nf5.size(); i += 2)
      role_closure[(size_t)nf5[i] * nr + nf5[i + 1]] = 1;
    for (int32_t k = 0; k < nr; k++)
      for (int32_t i = 0; i < nr; i++)
        if (role_closure[(size_t)i * nr + k])
          for (int32_t j = 0; j < nr; j++)
            if (role_closure[(size_t)k * nr + j]) role_closure[(size_t)i * nr + j] = 1;

    // close links under chain targets; build chain_pairs (r_first, l2, lt).
    // dedup key packs (r, l2, lt) disjointly: r < 2^20 roles, l2/lt < 2^22
    // links — far above real ontologies (SNOMED: ~60 roles, ~300k links).
    if (!nf6.empty()) {
      std::unordered_set<uint64_t> seen;
      bool changed = true;
      while (changed) {
        changed = false;
        for (size_t c = 0; c + 3 <= nf6.size(); c += 3) {
          int32_t r = nf6[c], s = nf6[c + 1], t = nf6[c + 2];
          size_t L = links.size() / 2;  // snapshot
          for (size_t l2 = 0; l2 < L; l2++) {
            int32_t r2 = links[l2 * 2], f2 = links[l2 * 2 + 1];
            if (!role_closure[(size_t)r2 * nr + s]) continue;
            int32_t lt = link_of(t, f2);
            uint64_t key = ((uint64_t)r << 44) | ((uint64_t)l2 << 22) | (uint64_t)lt;
            if (seen.insert(key).second) {
              chain_pairs.push_back(r);
              chain_pairs.push_back((int32_t)l2);
              chain_pairs.push_back(lt);
              changed = true;
            }
          }
        }
      }
    }
  }
};

}  // namespace

// ------------------------------------------------------------------ C ABI

extern "C" {

struct DistelLoadResult {
  // entity tables: names newline-joined
  char* concept_names; int64_t concept_names_len; int64_t n_concepts;
  char* role_names;    int64_t role_names_len;    int64_t n_roles;
  // axiom arrays (row-major int32)
  int32_t* nf1; int64_t k1;
  int32_t* nf2; int64_t k2;
  int32_t* nf3; int64_t k3;
  int32_t* nf4; int64_t k4;
  int32_t* links; int64_t n_links;
  int32_t* chain_pairs; int64_t n_chain_pairs;
  uint8_t* role_closure;  // n_roles_closure^2
  int64_t n_roles_closure;
  char* removed;  // "kind=count\n" report
  int64_t removed_len;
  char* error;    // non-null on failure
};

static char* dup_str(const std::string& s) {
  char* p = (char*)malloc(s.size() + 1);
  memcpy(p, s.data(), s.size());
  p[s.size()] = 0;
  return p;
}

static int32_t* dup_i32(const std::vector<int32_t>& v) {
  int32_t* p = (int32_t*)malloc(std::max<size_t>(v.size(), 1) * sizeof(int32_t));
  if (!v.empty()) memcpy(p, v.data(), v.size() * sizeof(int32_t));
  return p;
}

DistelLoadResult* distel_load(const char* text, int64_t len) {
  auto* out = (DistelLoadResult*)calloc(1, sizeof(DistelLoadResult));
  Tokenizer tz{text, (size_t)len};
  if (!tz.run()) { out->error = dup_str(tz.error); return out; }
  Parser parser(text, tz.toks);
  if (!parser.parse_document()) { out->error = dup_str(parser.error); return out; }
  Normalizer nz(parser);
  nz.pass1();
  nz.lower();
  nz.finish();

  std::string cn, rn;
  for (auto& s : nz.concept_names) { cn += s; cn += '\n'; }
  for (auto& s : nz.role_names) { rn += s; rn += '\n'; }
  out->concept_names = dup_str(cn); out->concept_names_len = (int64_t)cn.size();
  out->n_concepts = (int64_t)nz.concept_names.size();
  out->role_names = dup_str(rn); out->role_names_len = (int64_t)rn.size();
  out->n_roles = (int64_t)std::max<size_t>(nz.role_names.size(), 1);
  out->nf1 = dup_i32(nz.nf1); out->k1 = (int64_t)nz.nf1.size() / 2;
  out->nf2 = dup_i32(nz.nf2); out->k2 = (int64_t)nz.nf2.size() / 3;
  out->nf3 = dup_i32(nz.nf3); out->k3 = (int64_t)nz.nf3.size() / 2;
  out->nf4 = dup_i32(nz.nf4); out->k4 = (int64_t)nz.nf4.size() / 3;
  out->links = dup_i32(nz.links); out->n_links = (int64_t)nz.links.size() / 2;
  out->chain_pairs = dup_i32(nz.chain_pairs);
  out->n_chain_pairs = (int64_t)nz.chain_pairs.size() / 3;
  int64_t nr = (int64_t)std::max<size_t>(nz.role_names.size(), 1);
  out->n_roles_closure = nr;
  out->role_closure = (uint8_t*)malloc((size_t)nr * nr);
  if ((size_t)nr * nr == nz.role_closure.size())
    memcpy(out->role_closure, nz.role_closure.data(), (size_t)nr * nr);
  else {  // no roles: identity 1x1
    out->role_closure[0] = 1;
  }
  std::string rem;
  for (auto& kv : nz.removed) rem += kv.first + "=" + std::to_string(kv.second) + "\n";
  out->removed = dup_str(rem); out->removed_len = (int64_t)rem.size();
  return out;
}

void distel_free(DistelLoadResult* r) {
  if (!r) return;
  free(r->concept_names); free(r->role_names);
  free(r->nf1); free(r->nf2); free(r->nf3); free(r->nf4);
  free(r->links); free(r->chain_pairs); free(r->role_closure);
  free(r->removed); free(r->error);
  free(r);
}

}  // extern "C"
