// Native chemistry kernel: SMILES parsing + Morgan/ECFP fingerprints.
//
// The host-side fast path for corpus fingerprinting (role of RDKit's C++ in
// the reference retriever, retrieve/retrieve_faiss.py:18-50). Semantics are
// bit-identical to the python implementation in chem/mol.py +
// chem/fingerprints.py: same implicit-H rules, same ring perception, same
// 32-bit hash mixing — tests assert exact equality of fingerprints.
//
// Build: g++ -O2 -shared -fPIC -o _cchem.so _cchem.cpp   (chem/native.py
// does this automatically on first use).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <functional>
#include <map>
#include <set>
#include <string>
#include <vector>

namespace {

constexpr uint32_t MASK32 = 0xFFFFFFFFu;

uint32_t mix(uint32_t h, uint32_t v) {
  h ^= v;
  h = (h * 0x9E3779B1u) & MASK32;
  h ^= h >> 16;
  return h;
}

uint32_t hash_ints(const std::vector<uint32_t>& vals) {
  uint32_t h = 0x811C9DC5u;
  for (uint32_t v : vals) h = mix(h, v);
  return h;
}

// --- periodic table subset (matches chem/mol.py ATOMIC_NUM) ---
int atomic_num(const std::string& sym) {
  static const std::map<std::string, int> table = {
      {"H", 1},  {"He", 2}, {"Li", 3}, {"Be", 4}, {"B", 5},  {"C", 6},
      {"N", 7},  {"O", 8},  {"F", 9},  {"Ne", 10}, {"Na", 11}, {"Mg", 12},
      {"Al", 13}, {"Si", 14}, {"P", 15}, {"S", 16}, {"Cl", 17}, {"Ar", 18},
      {"K", 19}, {"Ca", 20}, {"Sc", 21}, {"Ti", 22}, {"V", 23}, {"Cr", 24},
      {"Mn", 25}, {"Fe", 26}, {"Co", 27}, {"Ni", 28}, {"Cu", 29}, {"Zn", 30},
      {"Ga", 31}, {"Ge", 32}, {"As", 33}, {"Se", 34}, {"Br", 35}, {"Kr", 36},
      {"Rb", 37}, {"Sr", 38}, {"Y", 39}, {"Zr", 40}, {"Nb", 41}, {"Mo", 42},
      {"Tc", 43}, {"Ru", 44}, {"Rh", 45}, {"Pd", 46}, {"Ag", 47}, {"Cd", 48},
      {"In", 49}, {"Sn", 50}, {"Sb", 51}, {"Te", 52}, {"I", 53}, {"Xe", 54},
      {"Cs", 55}, {"Ba", 56}, {"La", 57}, {"Ce", 58}, {"Pr", 59}, {"Nd", 60},
      {"Sm", 62}, {"Eu", 63}, {"Gd", 64}, {"Tb", 65}, {"Dy", 66}, {"Ho", 67},
      {"Er", 68}, {"Tm", 69}, {"Yb", 70}, {"Lu", 71}, {"Hf", 72}, {"Ta", 73},
      {"W", 74}, {"Re", 75}, {"Os", 76}, {"Ir", 77}, {"Pt", 78}, {"Au", 79},
      {"Hg", 80}, {"Tl", 81}, {"Pb", 82}, {"Bi", 83}, {"Po", 84}, {"At", 85},
      {"Rn", 86}, {"Fr", 87}, {"Ra", 88}, {"Ac", 89}, {"Th", 90}, {"Pa", 91},
      {"U", 92}};
  auto it = table.find(sym);
  return it == table.end() ? 0 : it->second;
}

enum BondKind { SINGLE = 1, DOUBLE = 2, TRIPLE = 3, QUAD = 4, AROMATIC = 5 };

constexpr int CHI_NONE = 0, CHI_CW = 1, CHI_CCW = 2;
constexpr int H_MARKER = -1000;  // chiral bracket-H slot in neighbor orders

struct Atom {
  std::string symbol;
  bool aromatic = false;
  int charge = 0;
  int isotope = 0;
  int explicit_h = -1;  // -1 -> compute implicit
  int implicit_h = 0;
  int atom_map = 0;
  int chirality = CHI_NONE;
  int total_h() const { return explicit_h >= 0 ? explicit_h : implicit_h; }
};

struct Bond {
  int a1, a2;
  int order = SINGLE;
  bool aromatic = false;
  int direction = 0;  // +1 '/', -1 '\\' oriented a1->a2
};

struct Mol {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
  std::vector<std::vector<int>> adj;  // atom -> bond indices
  // per-atom SMILES appearance order of neighbors (+ H_MARKER slots),
  // mirror of chem/mol.py smiles_neighbor_order
  std::vector<std::vector<int>> nbr_order;

  int add_atom(Atom a) {
    atoms.push_back(std::move(a));
    adj.emplace_back();
    return (int)atoms.size() - 1;
  }
  void add_bond(int a1, int a2, int order, bool aromatic, int direction = 0) {
    bonds.push_back({a1, a2, order, aromatic, direction});
    adj[a1].push_back((int)bonds.size() - 1);
    adj[a2].push_back((int)bonds.size() - 1);
  }
  int other(int b, int a) const { return bonds[b].a1 == a ? bonds[b].a2 : bonds[b].a1; }
};

bool is_organic_subset(const std::string& s) {
  return s == "B" || s == "C" || s == "N" || s == "O" || s == "P" ||
         s == "S" || s == "F" || s == "Cl" || s == "Br" || s == "I";
}

const std::vector<int>* default_valences(const std::string& s) {
  static const std::map<std::string, std::vector<int>> v = {
      {"B", {3}}, {"C", {4}}, {"N", {3, 5}}, {"O", {2}}, {"P", {3, 5}},
      {"S", {2, 4, 6}}, {"F", {1}}, {"Cl", {1}}, {"Br", {1}}, {"I", {1}}};
  auto it = v.find(s);
  return it == v.end() ? nullptr : &it->second;
}

void assign_implicit_h(Mol& mol) {
  for (size_t i = 0; i < mol.atoms.size(); ++i) {
    Atom& a = mol.atoms[i];
    if (a.explicit_h >= 0) { a.implicit_h = a.explicit_h; continue; }
    if (!is_organic_subset(a.symbol) || a.charge != 0) { a.implicit_h = 0; continue; }
    int order_sum = 0;
    for (int b : mol.adj[i])
      order_sum += mol.bonds[b].aromatic ? 1 : mol.bonds[b].order;
    if (a.aromatic && (a.symbol == "B" || a.symbol == "C" ||
                       a.symbol == "N" || a.symbol == "P"))
      order_sum += 1;
    int h = 0;
    const auto* vals = default_valences(a.symbol);
    if (vals) {
      if (a.aromatic) {
        // no valence promotion for aromatic atoms (mirror of mol.py):
        // a bare 3-connected aromatic N has zero implicit H
        h = std::max(0, (*vals)[0] - order_sum);
      } else {
        for (int v : *vals)
          if (order_sum <= v) { h = v - order_sum; break; }
      }
    }
    a.implicit_h = h;
  }
}

// --- aromaticity perception (mirror of chem/aromatic.py) -------------------
constexpr int MAX_RING = 7;

bool aromatic_capable(const std::string& s) {
  return s == "B" || s == "C" || s == "N" || s == "O" || s == "P" ||
         s == "S" || s == "As" || s == "Se" || s == "Te";
}

// shortest cycle containing bond bidx (BFS avoiding the bond itself,
// neighbors in adjacency order); ring returned as dst..src like the python.
bool shortest_cycle_through(const Mol& mol, int bidx, std::vector<int>* out) {
  const int src = mol.bonds[bidx].a1, dst = mol.bonds[bidx].a2;
  std::vector<int> prev(mol.atoms.size(), -2);
  std::vector<int> depth(mol.atoms.size(), 0);
  prev[src] = -1;
  std::vector<int> queue = {src};
  while (!queue.empty()) {
    std::vector<int> nxt;
    for (int a : queue) {
      if (depth[a] + 2 > MAX_RING) return false;
      for (int nb : mol.adj[a]) {
        if (nb == bidx) continue;
        int o = mol.other(nb, a);
        if (prev[o] != -2) continue;
        prev[o] = a;
        depth[o] = depth[a] + 1;
        if (o == dst) {
          out->clear();
          for (int x = o; x != -1; x = prev[x]) out->push_back(x);
          return true;
        }
        nxt.push_back(o);
      }
    }
    queue = std::move(nxt);
  }
  return false;
}

std::vector<std::vector<int>> candidate_rings(const Mol& mol) {
  std::vector<std::vector<int>> rings;
  std::set<std::vector<int>> seen;
  std::vector<int> ring;
  for (int b = 0; b < (int)mol.bonds.size(); ++b) {
    if (!shortest_cycle_through(mol, b, &ring)) continue;
    if ((int)ring.size() < 3 || (int)ring.size() > MAX_RING) continue;
    std::vector<int> key = ring;
    std::sort(key.begin(), key.end());
    if (!seen.insert(key).second) continue;
    rings.push_back(ring);
  }
  return rings;
}

// pi electron count of the ring, or -1 when an atom disqualifies it
int ring_pi_electrons(const Mol& mol, const std::vector<int>& ring) {
  std::set<int> ring_set(ring.begin(), ring.end());
  int total = 0;
  for (int a : ring) {
    const Atom& atom = mol.atoms[a];
    if (!aromatic_capable(atom.symbol)) return -1;
    if ((int)mol.adj[a].size() + atom.total_h() > 3) return -1;
    bool in_ring_pi = false, exo_double = false;
    for (int bidx : mol.adj[a]) {
      const Bond& b = mol.bonds[bidx];
      if (b.order >= TRIPLE) return -1;
      bool is_pi = b.aromatic || b.order == AROMATIC || b.order == DOUBLE;
      if (!is_pi) continue;
      if (ring_set.count(mol.other(bidx, a))) in_ring_pi = true;
      else if (b.order == DOUBLE) exo_double = true;
    }
    if (in_ring_pi) {
      total += 1;
    } else if (exo_double) {
      total += 0;
    } else {
      const std::string& sym = atom.symbol;
      int q = atom.charge;
      if ((sym == "N" || sym == "P" || sym == "As") && (q == 0 || q == -1))
        total += 2;
      else if ((sym == "O" || sym == "S" || sym == "Se" || sym == "Te") && q == 0)
        total += 2;
      else if (sym == "C" && q == -1) total += 2;
      else if (sym == "C" && q == 1) total += 0;
      else if (sym == "B" && q == 0) total += 0;
      else return -1;
    }
  }
  return total;
}

bool ring_edge(const std::vector<int>& ring, int a1, int a2) {
  const int n = (int)ring.size();
  for (int i = 0; i < n; ++i) {
    int x = ring[i], y = ring[(i + 1) % n];
    if ((x == a1 && y == a2) || (x == a2 && y == a1)) return true;
  }
  return false;
}

void perceive_aromaticity(Mol& mol) {
  auto rings = candidate_rings(mol);
  if (rings.empty()) return;
  std::vector<int> pending(rings.size());
  for (size_t i = 0; i < rings.size(); ++i) pending[i] = (int)i;
  bool changed = true;
  while (changed && !pending.empty()) {
    changed = false;
    std::vector<int> still;
    for (int ri : pending) {
      const std::vector<int>& ring = rings[ri];
      std::set<int> ring_set(ring.begin(), ring.end());
      bool already = true;
      for (int a : ring)
        if (!mol.atoms[a].aromatic) { already = false; break; }
      if (already)
        for (const Bond& b : mol.bonds)
          if (ring_set.count(b.a1) && ring_set.count(b.a2) &&
              ring_edge(ring, b.a1, b.a2) && !b.aromatic) {
            already = false;
            break;
          }
      if (already) continue;
      int pi = ring_pi_electrons(mol, ring);
      if (pi >= 2 && (pi - 2) % 4 == 0) {
        for (int a : ring) mol.atoms[a].aromatic = true;
        for (Bond& b : mol.bonds)
          if (ring_set.count(b.a1) && ring_set.count(b.a2) &&
              ring_edge(ring, b.a1, b.a2)) {
            b.order = SINGLE;
            b.aromatic = true;
            b.direction = 0;
          }
        changed = true;
      } else {
        still.push_back(ri);
      }
    }
    pending = std::move(still);
  }
}

struct ParseError {};

Atom parse_bracket(const std::string& body) {
  Atom atom;
  size_t i = 0;
  while (i < body.size() && isdigit((unsigned char)body[i]))
    atom.isotope = atom.isotope * 10 + (body[i++] - '0');
  if (i >= body.size()) throw ParseError{};
  std::string sym;
  if (body[i] == '*') { sym = "*"; ++i; }
  else if (isupper((unsigned char)body[i])) {
    sym += body[i++];
    // greedy two-letter element match (mirrors the python regex
    // [A-Z][a-z]? semantics: any trailing lowercase char joins the symbol)
    if (i < body.size() && islower((unsigned char)body[i])) {
      sym += body[i++];
    }
  } else if (islower((unsigned char)body[i])) {
    // aromatic lowercase symbol, possibly two letters (se, as, te)
    atom.aromatic = true;
    sym += (char)toupper((unsigned char)body[i++]);
    if (i < body.size() && islower((unsigned char)body[i]) && body[i] != 'h') {
      std::string cap = sym + std::string(1, body[i]);
      if (atomic_num(cap) > 0) { sym = cap; ++i; }
    }
  } else {
    throw ParseError{};
  }
  if (sym != "*" && atomic_num(sym) == 0) throw ParseError{};
  atom.symbol = sym;
  // chirality
  {
    int ats = 0;
    while (i < body.size() && body[i] == '@') { ++ats; ++i; }
    if (ats == 1) atom.chirality = CHI_CCW;
    else if (ats >= 2) atom.chirality = CHI_CW;
    if (i < body.size() && (body.compare(i, 2, "TH") == 0 || body.compare(i, 2, "AL") == 0 ||
                            body.compare(i, 2, "SP") == 0 || body.compare(i, 2, "TB") == 0 ||
                            body.compare(i, 2, "OH") == 0)) {
      i += 2;
      while (i < body.size() && isdigit((unsigned char)body[i])) ++i;
    }
  }
  atom.explicit_h = 0;
  if (i < body.size() && body[i] == 'H') {
    ++i;
    atom.explicit_h = 1;
    if (i < body.size() && isdigit((unsigned char)body[i])) {
      atom.explicit_h = 0;
      while (i < body.size() && isdigit((unsigned char)body[i]))
        atom.explicit_h = atom.explicit_h * 10 + (body[i++] - '0');
    }
  }
  if (i < body.size() && (body[i] == '+' || body[i] == '-')) {
    char sign = body[i];
    int count = 0;
    while (i < body.size() && body[i] == sign) { ++count; ++i; }
    if (i < body.size() && isdigit((unsigned char)body[i])) {
      count = 0;
      while (i < body.size() && isdigit((unsigned char)body[i]))
        count = count * 10 + (body[i++] - '0');
    }
    atom.charge = sign == '+' ? count : -count;
  }
  if (i < body.size() && body[i] == ':') {
    ++i;
    while (i < body.size() && isdigit((unsigned char)body[i]))
      atom.atom_map = atom.atom_map * 10 + (body[i++] - '0');
  }
  if (i != body.size()) throw ParseError{};
  return atom;
}

Mol parse_smiles(const std::string& smiles) {
  Mol mol;
  int prev = -1;
  char pending = 0;
  std::vector<std::pair<int, char>> stack;
  std::map<int, std::pair<int, char>> ring_open;

  // mirrors chem/mol.py _bond_props: '/'='\\' are directed singles; ':'
  // is explicitly aromatic; no symbol between two aromatic atoms makes an
  // aromatic bond
  auto bond_props = [&](char ch, int a1, int a2, int* order, bool* aromatic,
                        int* direction) {
    *direction = 0;
    if (ch == 0) {
      *order = SINGLE;
      *aromatic = mol.atoms[a1].aromatic && mol.atoms[a2].aromatic;
      return;
    }
    if (ch == '/') { *order = SINGLE; *aromatic = false; *direction = +1; return; }
    if (ch == '\\') { *order = SINGLE; *aromatic = false; *direction = -1; return; }
    *aromatic = ch == ':';
    switch (ch) {
      case '=': *order = DOUBLE; break;
      case '#': *order = TRIPLE; break;
      case '$': *order = QUAD; break;
      default: *order = SINGLE; break;
    }
  };

  auto add_atom = [&](Atom a) {
    bool chiral_h = a.chirality != CHI_NONE && a.explicit_h == 1;
    int cur = mol.add_atom(std::move(a));
    mol.nbr_order.emplace_back();
    if (prev >= 0) {
      int order, direction; bool arom;
      bond_props(pending, prev, cur, &order, &arom, &direction);
      mol.add_bond(prev, cur, order, arom, direction);
      mol.nbr_order[prev].push_back(cur);
      mol.nbr_order[cur].push_back(prev);
    }
    // bracket hydrogen on a chiral center occupies the next neighbor slot
    if (chiral_h) mol.nbr_order[cur].push_back(H_MARKER);
    pending = 0;
    prev = cur;
  };

  auto ring = [&](int num) {
    if (prev < 0) throw ParseError{};
    auto it = ring_open.find(num);
    if (it != ring_open.end()) {
      int other = it->second.first;
      char ch = pending ? pending : it->second.second;
      ring_open.erase(it);
      int order, direction; bool arom;
      bond_props(ch, other, prev, &order, &arom, &direction);
      mol.add_bond(other, prev, order, arom, direction);
      // opener's placeholder becomes the closing atom; closer appends
      int placeholder = -num - 1;
      for (auto& e : mol.nbr_order[other])
        if (e == placeholder) { e = prev; break; }
      mol.nbr_order[prev].push_back(other);
    } else {
      ring_open[num] = {prev, pending};
      mol.nbr_order[prev].push_back(-num - 1);
    }
    pending = 0;
  };

  size_t i = 0, n = smiles.size();
  while (i < n) {
    char c = smiles[i];
    if (c == '[') {
      size_t j = smiles.find(']', i);
      if (j == std::string::npos) throw ParseError{};
      add_atom(parse_bracket(smiles.substr(i + 1, j - i - 1)));
      i = j + 1;
    } else if (c == 'C' && i + 1 < n && smiles[i + 1] == 'l') {
      add_atom({.symbol = "Cl"}); i += 2;
    } else if (c == 'B' && i + 1 < n && smiles[i + 1] == 'r') {
      add_atom({.symbol = "Br"}); i += 2;
    } else if (strchr("BCNOPSFI", c)) {
      add_atom({.symbol = std::string(1, c)}); ++i;
    } else if (strchr("bcnops", c)) {
      Atom a; a.symbol = std::string(1, (char)toupper(c)); a.aromatic = true;
      add_atom(std::move(a)); ++i;
    } else if (c == '*') {
      add_atom({.symbol = "*"}); ++i;
    } else if (strchr("-=#$:/\\~", c)) {
      pending = (c == '~') ? '-' : c; ++i;
    } else if (c == '(') {
      stack.push_back({prev, pending}); pending = 0; ++i;
    } else if (c == ')') {
      if (stack.empty()) throw ParseError{};
      prev = stack.back().first; pending = stack.back().second;
      stack.pop_back(); ++i;
    } else if (isdigit((unsigned char)c)) {
      ring(c - '0'); ++i;
    } else if (c == '%') {
      if (i + 2 >= n || !isdigit((unsigned char)smiles[i + 1]) ||
          !isdigit((unsigned char)smiles[i + 2])) throw ParseError{};
      ring((smiles[i + 1] - '0') * 10 + (smiles[i + 2] - '0'));
      i += 3;
    } else if (c == '.') {
      prev = -1; pending = 0; ++i;
    } else if (c == ' ' || c == '\t') {
      break;
    } else {
      throw ParseError{};
    }
  }
  if (!ring_open.empty() || !stack.empty()) throw ParseError{};
  assign_implicit_h(mol);
  perceive_aromaticity(mol);
  return mol;
}

// ===========================================================================
// Canonical SMILES (mirror of chem/canon.py: WL-refinement ranks +
// deterministic DFS writer with chirality parity and cis/trans
// normalization). Tests assert string equality with the python
// implementation over randomized atom orders.
// ===========================================================================

using Key = std::vector<long long>;

std::map<int, int> ranks_from_keys(const std::vector<int>& atoms,
                                   const std::map<int, Key>& keys) {
  std::vector<Key> uniq;
  uniq.reserve(atoms.size());
  for (int a : atoms) uniq.push_back(keys.at(a));
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  std::map<int, int> out;
  for (int a : atoms)
    out[a] = (int)(std::lower_bound(uniq.begin(), uniq.end(), keys.at(a)) -
                   uniq.begin());
  return out;
}

int bond_rank_key(const Bond& b) { return b.aromatic ? AROMATIC + 1 : b.order; }

size_t count_classes(const std::map<int, int>& r) {
  std::vector<int> vals;
  for (auto& kv : r) vals.push_back(kv.second);
  std::sort(vals.begin(), vals.end());
  vals.erase(std::unique(vals.begin(), vals.end()), vals.end());
  return vals.size();
}

int permutation_parity(std::vector<int> perm);

std::map<int, int> canonical_ranks(const Mol& mol,
                                   const std::vector<int>& atoms,
                                   bool tie_break = true) {
  std::map<int, bool> in_set;
  for (int a : atoms) in_set[a] = true;
  std::map<int, Key> inv;
  for (int a : atoms) {
    const Atom& at = mol.atoms[a];
    inv[a] = Key{atomic_num(at.symbol), (long long)mol.adj[a].size(),
                 at.charge, at.total_h(), at.aromatic ? 1 : 0, at.isotope};
  }
  auto ranks = ranks_from_keys(atoms, inv);

  auto refine = [&](std::map<int, int> r) {
    for (;;) {
      std::map<int, Key> keys;
      for (int a : atoms) {
        std::vector<std::pair<long long, long long>> nbr;
        for (int b : mol.adj[a]) {
          int o = mol.other(b, a);
          if (!in_set.count(o)) continue;
          nbr.push_back({bond_rank_key(mol.bonds[b]), r.at(o)});
        }
        std::sort(nbr.begin(), nbr.end());
        Key key{r.at(a)};
        for (auto& p : nbr) { key.push_back(p.first); key.push_back(p.second); }
        keys[a] = std::move(key);
      }
      auto nr = ranks_from_keys(atoms, keys);
      if (count_classes(nr) == count_classes(r)) return nr;
      r = std::move(nr);
    }
  };

  ranks = refine(ranks);

  // Stereo-aware refinement (bit-identical mirror of canon.py): split
  // rank-tied chiral atoms by the spelling-invariant descriptor
  // tag (x) parity(SMILES neighbor order -> rank order); without it a
  // meso compound written from either end canonicalizes differently.
  bool any_chiral = false;
  for (int a : atoms)
    if (mol.atoms[a].chirality != CHI_NONE) { any_chiral = true; break; }
  while (any_chiral) {
    std::map<int, Key> keys;
    for (int a : atoms) {
      long long d = 0;
      const Atom& at = mol.atoms[a];
      if (at.chirality != CHI_NONE && a < (int)mol.nbr_order.size() &&
          !mol.nbr_order[a].empty()) {
        const std::vector<int>& orig = mol.nbr_order[a];
        std::vector<long long> ks;
        ks.reserve(orig.size());
        bool ok = true;
        for (int x : orig) {
          if (x == H_MARKER) ks.push_back(-1);
          else if (ranks.count(x)) ks.push_back(ranks.at(x));
          else { ok = false; break; }  // neighbor outside ranked subset
        }
        if (ok) {
          std::set<long long> uniq(ks.begin(), ks.end());
          if (uniq.size() == ks.size()) {  // ties: parity ill-defined
            std::vector<int> order(orig.size());
            for (size_t i = 0; i < order.size(); ++i) order[i] = (int)i;
            std::sort(order.begin(), order.end(),
                      [&](int i, int j) { return ks[i] < ks[j]; });
            if (permutation_parity(order))
              d = at.chirality == CHI_CCW ? CHI_CW : CHI_CCW;
            else
              d = at.chirality;
          }
        }
      }
      keys[a] = Key{ranks.at(a), d};
    }
    auto nr = refine(ranks_from_keys(atoms, keys));
    if (count_classes(nr) == count_classes(ranks)) break;
    ranks = std::move(nr);
  }

  if (!tie_break) return ranks;  // refinement fixpoint (graph-equivalence
                                 // classes) for drop_nonstereogenic_tags

  while (count_classes(ranks) < atoms.size()) {
    // split the lowest tied class at its lowest-index member
    std::map<int, std::vector<int>> by_rank;
    for (int a : atoms) by_rank[ranks[a]].push_back(a);
    int tied = -1;
    for (auto& kv : by_rank)
      if (kv.second.size() > 1) { tied = kv.first; break; }
    int chosen = *std::min_element(by_rank[tied].begin(), by_rank[tied].end());
    std::map<int, Key> keys;
    for (int a : atoms)
      keys[a] = Key{ranks[a], a == chosen ? 0 : 1};
    ranks = refine(ranks_from_keys(atoms, keys));
  }
  return ranks;
}

int permutation_parity(std::vector<int> perm) {
  int parity = 0;
  for (size_t i = 0; i < perm.size(); ++i) {
    while (perm[i] != (int)i) {
      std::swap(perm[i], perm[perm[i]]);
      parity ^= 1;
    }
  }
  return parity;
}

int reader_inferred_h(const Mol& mol, int idx) {
  const Atom& at = mol.atoms[idx];
  int order_sum = 0;
  for (int b : mol.adj[idx])
    order_sum += mol.bonds[b].aromatic ? 1 : mol.bonds[b].order;
  if (at.aromatic && (at.symbol == "B" || at.symbol == "C" ||
                      at.symbol == "N" || at.symbol == "P"))
    order_sum += 1;
  const auto* vals = default_valences(at.symbol);
  if (vals) {
    if (at.aromatic) return std::max(0, (*vals)[0] - order_sum);
    for (int v : *vals)
      if (order_sum <= v) return v - order_sum;
  }
  return 0;
}

std::string atom_token(const Mol& mol, int idx, int chi_out) {
  const Atom& at = mol.atoms[idx];
  std::string sym = at.symbol;
  if (at.aromatic)
    for (auto& c : sym) c = (char)tolower((unsigned char)c);
  bool plain_symbol = at.symbol == "B" || at.symbol == "C" || at.symbol == "N" ||
                      at.symbol == "O" || at.symbol == "P" || at.symbol == "S" ||
                      at.symbol == "F" || at.symbol == "Cl" ||
                      at.symbol == "Br" || at.symbol == "I" || at.symbol == "*";
  bool needs_bracket = !plain_symbol || at.charge != 0 || at.isotope != 0 ||
                       chi_out != CHI_NONE ||
                       at.total_h() != reader_inferred_h(mol, idx) ||
                       at.atom_map != 0;
  if (!needs_bracket) return sym;
  std::string out = "[";
  if (at.isotope) out += std::to_string(at.isotope);
  out += sym;
  if (chi_out == CHI_CCW) out += "@";
  else if (chi_out == CHI_CW) out += "@@";
  int h = at.total_h();
  if (h == 1) out += "H";
  else if (h > 1) out += "H" + std::to_string(h);
  if (at.charge == 1) out += "+";
  else if (at.charge == -1) out += "-";
  else if (at.charge > 1) out += "+" + std::to_string(at.charge);
  else if (at.charge < -1) out += "-" + std::to_string(-at.charge);
  if (at.atom_map) out += ":" + std::to_string(at.atom_map);
  out += "]";
  return out;
}

struct Writer {
  const Mol& mol;
  const std::map<int, int>& rank_of;
  std::vector<int> atoms;
  std::map<int, bool> in_set;

  std::map<int, int> parent_bond;           // atom -> bond idx
  std::map<int, std::vector<int>> children;  // atom -> bond idxs
  std::map<int, std::vector<int>> ring_bonds_at;
  std::vector<bool> seen_bond;
  std::map<int, bool> visited;

  std::map<int, int> ring_digit;            // bond -> digit
  int next_digit = 1;
  std::vector<int> free_digits;
  std::map<int, bool> dir_flip;
  std::vector<std::pair<int, char>> dir_emit_order;
  std::string pieces;

  Writer(const Mol& m, const std::map<int, int>& r, std::vector<int> a)
      : mol(m), rank_of(r), atoms(std::move(a)),
        seen_bond(m.bonds.size(), false) {
    for (int x : atoms) in_set[x] = true;
  }

  std::vector<int> sorted_bonds(int a) {
    std::vector<int> out;
    for (int b : mol.adj[a])
      if (in_set.count(mol.other(b, a))) out.push_back(b);
    std::stable_sort(out.begin(), out.end(), [&](int x, int y) {
      return rank_of.at(mol.other(x, a)) < rank_of.at(mol.other(y, a));
    });
    return out;
  }

  void classify(int a) {
    for (int b : sorted_bonds(a)) {
      if (seen_bond[b]) continue;
      int o = mol.other(b, a);
      seen_bond[b] = true;
      if (visited.count(o)) {
        ring_bonds_at[a].push_back(b);
        ring_bonds_at[o].push_back(b);
      } else {
        visited[o] = true;
        parent_bond[o] = b;
        children[a].push_back(b);
        classify(o);
      }
    }
  }

  char direction_sym(int b, int src) {
    const Bond& bond = mol.bonds[b];
    bool up = bond.direction == +1;
    if (bond.a1 != src) up = !up;
    auto it = dir_flip.find(b);
    if (it != dir_flip.end() && it->second) up = !up;
    char sym = up ? '/' : '\\';
    dir_emit_order.push_back({b, sym});
    return sym;
  }

  std::string bond_symbol(int b, int src) {
    const Bond& bond = mol.bonds[b];
    if (bond.aromatic) return "";
    if (bond.direction != 0) return std::string(1, direction_sym(b, src));
    if (bond.order == SINGLE) {
      if (mol.atoms[bond.a1].aromatic && mol.atoms[bond.a2].aromatic)
        return "-";
      return "";
    }
    switch (bond.order) {
      case DOUBLE: return "=";
      case TRIPLE: return "#";
      case QUAD: return "$";
    }
    return "";
  }

  std::string bond_symbol_ring(int b, int src) {
    const Bond& bond = mol.bonds[b];
    if (bond.direction != 0 && !bond.aromatic && bond.order == SINGLE)
      return "";
    return bond_symbol(b, src);
  }

  int alloc_digit() {
    if (!free_digits.empty()) {
      int d = free_digits.front();
      free_digits.erase(free_digits.begin());
      return d;
    }
    return next_digit++;
  }

  std::string digit_token(int d, const std::string& sym) {
    if (d >= 10) {
      char buf[8];
      snprintf(buf, sizeof(buf), "%%%02d", d);
      return sym + buf;
    }
    return sym + std::to_string(d);
  }

  int chirality_out(int a, const std::vector<int>& written) {
    const Atom& at = mol.atoms[a];
    if (at.chirality == CHI_NONE) return CHI_NONE;
    const std::vector<int>& orig = mol.nbr_order[a];
    if (orig.size() != written.size()) return at.chirality;
    {
      auto so = orig;
      auto sw = written;
      std::sort(so.begin(), so.end());
      std::sort(sw.begin(), sw.end());
      if (so != sw) return at.chirality;
    }
    std::vector<int> perm;
    for (int x : written)
      perm.push_back((int)(std::find(orig.begin(), orig.end(), x) -
                           orig.begin()));
    if (permutation_parity(perm))
      return at.chirality == CHI_CCW ? CHI_CW : CHI_CCW;
    return at.chirality;
  }

  void write_atom(int a) {
    std::vector<int> written;
    auto pit = parent_bond.find(a);
    if (pit != parent_bond.end())
      written.push_back(mol.other(pit->second, a));
    const Atom& at = mol.atoms[a];
    if (at.chirality != CHI_NONE && at.explicit_h == 1)
      written.push_back(H_MARKER);
    for (int b : ring_bonds_at[a]) written.push_back(mol.other(b, a));
    for (int b : children[a]) written.push_back(mol.other(b, a));
    pieces += atom_token(mol, a, chirality_out(a, written));
    for (int b : ring_bonds_at[a]) {
      auto it = ring_digit.find(b);
      if (it != ring_digit.end()) {
        int d = it->second;
        ring_digit.erase(it);
        free_digits.push_back(d);
        std::sort(free_digits.begin(), free_digits.end());
        pieces += digit_token(d, bond_symbol_ring(b, a));
      } else {
        int d = alloc_digit();
        ring_digit[b] = d;
        pieces += digit_token(d, bond_symbol_ring(b, a));
      }
    }
    auto& kids = children[a];
    for (size_t i = 0; i < kids.size(); ++i) {
      int b = kids[i];
      int o = mol.other(b, a);
      bool last = i + 1 == kids.size();
      if (!last) pieces += "(";
      pieces += bond_symbol(b, a);
      write_atom(o);
      if (!last) pieces += ")";
    }
  }

  void fill_direction_flips() {
    std::vector<int> dir_bonds;
    for (auto& p : dir_emit_order) dir_bonds.push_back(p.first);
    std::sort(dir_bonds.begin(), dir_bonds.end());
    dir_bonds.erase(std::unique(dir_bonds.begin(), dir_bonds.end()),
                    dir_bonds.end());
    std::map<int, int> parent;
    for (int b : dir_bonds) parent[b] = b;
    std::function<int(int)> find = [&](int x) {
      while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
      return x;
    };
    auto unite = [&](int x, int y) {
      int rx = find(x), ry = find(y);
      if (rx != ry) parent[rx] = ry;
    };
    std::map<int, std::vector<int>> at_atom;
    for (int b : dir_bonds) {
      at_atom[mol.bonds[b].a1].push_back(b);
      at_atom[mol.bonds[b].a2].push_back(b);
    }
    for (auto& kv : at_atom)
      for (size_t i = 1; i < kv.second.size(); ++i)
        unite(kv.second[0], kv.second[i]);
    for (const Bond& db : mol.bonds) {
      if (db.order == DOUBLE && !db.aromatic) {
        auto i1 = at_atom.find(db.a1);
        auto i2 = at_atom.find(db.a2);
        if (i1 != at_atom.end() && i2 != at_atom.end() &&
            !i1->second.empty() && !i2->second.empty())
          unite(i1->second[0], i2->second[0]);
      }
    }
    std::map<int, char> first_sym;
    for (auto& p : dir_emit_order) {
      int root = find(p.first);
      if (!first_sym.count(root)) first_sym[root] = p.second;
    }
    for (int b : dir_bonds) dir_flip[b] = first_sym[find(b)] == '\\';
  }

  std::string run() {
    int start = atoms[0];
    for (int a : atoms)
      if (rank_of.at(a) < rank_of.at(start)) start = a;
    visited[start] = true;
    classify(start);
    write_atom(start);
    if (!dir_emit_order.empty()) {
      fill_direction_flips();
      bool any = false;
      for (auto& kv : dir_flip) any |= kv.second;
      if (any) {
        pieces.clear();
        ring_digit.clear();
        free_digits.clear();
        next_digit = 1;
        dir_emit_order.clear();
        write_atom(start);
      }
    }
    return pieces;
  }
};

std::vector<std::vector<int>> fragment_atom_sets(const Mol& mol) {
  std::vector<bool> seen(mol.atoms.size(), false);
  std::vector<std::vector<int>> comps;
  for (size_t start = 0; start < mol.atoms.size(); ++start) {
    if (seen[start]) continue;
    std::vector<int> comp, stack{(int)start};
    seen[start] = true;
    while (!stack.empty()) {
      int a = stack.back();
      stack.pop_back();
      comp.push_back(a);
      for (int b : mol.adj[a]) {
        int o = mol.other(b, a);
        if (!seen[o]) { seen[o] = true; stack.push_back(o); }
      }
    }
    std::sort(comp.begin(), comp.end());
    comps.push_back(std::move(comp));
  }
  return comps;
}

// Fold removable explicit [H] atoms into their neighbor's H count (mirror
// of chem/mol.py remove_explicit_hydrogens; RDKit MolFromSmiles removeHs
// default). Kept: charged, isotopic, mapped, non-single-bonded, H-H, or
// multi-degree hydrogens. A removed H neighbor of a chiral atom keeps its
// neighbor-order SLOT as the bracket-H marker so tag parity survives.
Mol remove_explicit_hydrogens_impl(const Mol& mol) {
  std::vector<bool> drop(mol.atoms.size(), false);
  bool any = false;
  std::vector<int> extra_h(mol.atoms.size(), 0);
  for (size_t i = 0; i < mol.atoms.size(); ++i) {
    const Atom& a = mol.atoms[i];
    if (a.symbol != "H" || a.charge != 0 || a.isotope != 0 || a.atom_map != 0)
      continue;
    if (mol.adj[i].size() != 1) continue;
    const Bond& b = mol.bonds[mol.adj[i][0]];
    if (b.order != SINGLE || b.aromatic) continue;
    int o = mol.other(mol.adj[i][0], (int)i);
    if (mol.atoms[o].symbol == "H") continue;
    drop[i] = true;
    any = true;
    extra_h[o] += 1;
  }
  if (!any) return mol;
  Mol out;
  std::vector<int> remap(mol.atoms.size(), -1);
  for (size_t i = 0; i < mol.atoms.size(); ++i) {
    if (drop[i]) continue;
    Atom a = mol.atoms[i];
    if (a.explicit_h >= 0) a.explicit_h += extra_h[i];
    remap[i] = out.add_atom(std::move(a));
  }
  for (const Bond& b : mol.bonds) {
    if (drop[b.a1] || drop[b.a2]) continue;
    out.add_bond(remap[b.a1], remap[b.a2], b.order, b.aromatic, b.direction);
  }
  out.nbr_order.resize(out.atoms.size());
  for (size_t i = 0; i < mol.nbr_order.size() && i < mol.atoms.size(); ++i) {
    if (drop[i]) continue;
    std::vector<int> entries;
    for (int x : mol.nbr_order[i]) {
      if (x == H_MARKER) entries.push_back(H_MARKER);
      else if (x >= 0 && drop[x]) {
        if (mol.atoms[i].chirality != CHI_NONE) entries.push_back(H_MARKER);
      } else entries.push_back(remap[x]);
    }
    out.nbr_order[remap[i]] = std::move(entries);
  }
  assign_implicit_h(out);
  return out;
}

// Bit-identical mirror of canon.py drop_nonstereogenic_tags: clear
// tetrahedral tags on atoms with two graph-equivalent neighbors at the
// stereo-aware refinement fixpoint (dependent ring-fusion stereo, e.g.
// decalin) — RDKit-legacy sanitize parity + canonical spelling invariance.
void drop_nonstereogenic_tags(Mol& mol) {
  for (;;) {
    std::vector<int> chiral;
    for (size_t a = 0; a < mol.atoms.size(); ++a)
      if (mol.atoms[a].chirality != CHI_NONE) chiral.push_back((int)a);
    if (chiral.empty()) return;
    std::vector<int> all(mol.atoms.size());
    for (size_t i = 0; i < all.size(); ++i) all[i] = (int)i;
    auto ranks = canonical_ranks(mol, all, /*tie_break=*/false);
    bool dropped = false;
    for (int a : chiral) {
      std::vector<int> nbr_ranks;
      for (int b : mol.adj[a]) nbr_ranks.push_back(ranks.at(mol.other(b, a)));
      std::set<int> uniq(nbr_ranks.begin(), nbr_ranks.end());
      if (uniq.size() != nbr_ranks.size()) {
        mol.atoms[a].chirality = CHI_NONE;
        dropped = true;
      }
    }
    if (!dropped) return;
  }
}

std::string canonical_smiles_impl(const std::string& smiles) {
  Mol mol = remove_explicit_hydrogens_impl(parse_smiles(smiles));
  drop_nonstereogenic_tags(mol);
  std::vector<std::string> frags;
  for (auto& frag : fragment_atom_sets(mol)) {
    auto ranks = canonical_ranks(mol, frag);
    Writer w(mol, ranks, frag);
    frags.push_back(w.run());
  }
  std::sort(frags.begin(), frags.end());
  std::string out;
  for (size_t i = 0; i < frags.size(); ++i) {
    if (i) out += ".";
    out += frags[i];
  }
  return out;
}

std::vector<bool> ring_membership(const Mol& mol) {
  size_t n = mol.atoms.size();
  std::vector<int> deg(n);
  std::vector<bool> removed(n, false);
  std::vector<int> stack;
  for (size_t i = 0; i < n; ++i) {
    deg[i] = (int)mol.adj[i].size();
    if (deg[i] <= 1) stack.push_back((int)i);
  }
  while (!stack.empty()) {
    int a = stack.back(); stack.pop_back();
    if (removed[a]) continue;
    removed[a] = true;
    for (int b : mol.adj[a]) {
      int o = mol.other(b, a);
      if (!removed[o] && --deg[o] <= 1) stack.push_back(o);
    }
  }
  std::vector<bool> in_ring(n);
  for (size_t i = 0; i < n; ++i)
    in_ring[i] = !removed[i] && !mol.adj[i].empty();
  return in_ring;
}

std::vector<uint32_t> morgan_identifiers(const Mol& mol, int radius) {
  auto in_ring = ring_membership(mol);
  size_t n = mol.atoms.size();
  std::vector<uint32_t> ids;
  std::vector<uint32_t> current(n);
  for (size_t a = 0; a < n; ++a) {
    const Atom& at = mol.atoms[a];
    current[a] = hash_ints({(uint32_t)atomic_num(at.symbol),
                            (uint32_t)mol.adj[a].size(),
                            (uint32_t)at.total_h(), (uint32_t)at.charge,
                            (uint32_t)(at.aromatic ? 1 : 0),
                            (uint32_t)(in_ring[a] ? 1 : 0),
                            (uint32_t)at.isotope});
  }
  ids.insert(ids.end(), current.begin(), current.end());
  for (int r = 1; r <= radius; ++r) {
    std::vector<uint32_t> nxt(n);
    for (size_t a = 0; a < n; ++a) {
      std::vector<std::pair<uint32_t, uint32_t>> env;
      for (int b : mol.adj[a]) {
        uint32_t bkey = mol.bonds[b].aromatic ? AROMATIC : mol.bonds[b].order;
        env.push_back({bkey, current[mol.other(b, (int)a)]});
      }
      std::sort(env.begin(), env.end());
      std::vector<uint32_t> flat = {(uint32_t)r, current[a]};
      for (auto& e : env) { flat.push_back(e.first); flat.push_back(e.second); }
      nxt[a] = hash_ints(flat);
    }
    ids.insert(ids.end(), nxt.begin(), nxt.end());
    current = std::move(nxt);
  }
  return ids;
}

int fingerprint_into(const std::string& smiles, int radius, int n_bits,
                     bool counts, int32_t* out) {
  try {
    // RDKit fingerprints post-MolFromSmiles mols (explicit H folded)
    Mol mol = remove_explicit_hydrogens_impl(parse_smiles(smiles));
    if (mol.atoms.empty()) return 1;
    for (uint32_t id : morgan_identifiers(mol, radius)) {
      int slot = (int)(id % (uint32_t)n_bits);
      if (counts) out[slot] += 1; else out[slot] = 1;
    }
    return 0;
  } catch (...) {
    return 1;
  }
}

}  // namespace

extern "C" {

// Binary/count Morgan fingerprint. Returns 0 on success; on parse failure
// writes methane's fingerprint (reference retrieve_faiss.py:42-43 fallback)
// and returns 1.
int cchem_morgan_fp(const char* smiles, int radius, int n_bits, int counts,
                    int32_t* out) {
  memset(out, 0, sizeof(int32_t) * (size_t)n_bits);
  if (fingerprint_into(smiles, radius, n_bits, counts, out) == 0) return 0;
  memset(out, 0, sizeof(int32_t) * (size_t)n_bits);
  fingerprint_into("C", radius, n_bits, counts, out);
  return 1;
}

// Reaction difference fingerprint: sum(product counts) - sum(reactant
// counts) over '>'-separated reaction SMILES. Returns 0 on success.
int cchem_reaction_fp(const char* rxn_smiles, int radius, int n_bits,
                      int32_t* out) {
  memset(out, 0, sizeof(int32_t) * (size_t)n_bits);
  std::string s(rxn_smiles);
  size_t first = s.find('>');
  if (first == std::string::npos) return 1;
  size_t last = s.rfind('>');
  std::string reactants = s.substr(0, first);
  std::string products = s.substr(last + 1);
  std::vector<int32_t> tmp(n_bits);
  auto accumulate = [&](const std::string& side, int sign) {
    size_t start = 0;
    while (start <= side.size()) {
      size_t dot = side.find('.', start);
      std::string frag = side.substr(
          start, dot == std::string::npos ? std::string::npos : dot - start);
      if (!frag.empty()) {
        std::fill(tmp.begin(), tmp.end(), 0);
        if (fingerprint_into(frag, radius, n_bits, true, tmp.data()) == 0)
          for (int i = 0; i < n_bits; ++i) out[i] += sign * tmp[i];
      }
      if (dot == std::string::npos) break;
      start = dot + 1;
    }
  };
  accumulate(products, +1);
  accumulate(reactants, -1);
  return 0;
}

// Batched binary Morgan fingerprints into an int8 matrix (rows x n_bits).
// smiles_blob: concatenated NUL-terminated strings.
void cchem_morgan_fp_batch(const char* smiles_blob, int n_rows, int radius,
                           int n_bits, int8_t* out) {
  const char* p = smiles_blob;
  std::vector<int32_t> buf(n_bits);
  for (int row = 0; row < n_rows; ++row) {
    std::fill(buf.begin(), buf.end(), 0);
    cchem_morgan_fp(p, radius, n_bits, 0, buf.data());
    int8_t* dst = out + (size_t)row * n_bits;
    for (int i = 0; i < n_bits; ++i) dst[i] = (int8_t)buf[i];
    p += strlen(p) + 1;
  }
}

// Canonical SMILES of a (possibly multi-fragment) molecule. Returns 0 and
// writes a NUL-terminated string on success; 1 on parse failure or
// overflow (caller falls back, mirroring chem/canon.py canonical_smiles).
int cchem_canonical_smiles(const char* smiles, char* out, int out_cap) {
  try {
    std::string canon = canonical_smiles_impl(smiles);
    if ((int)canon.size() + 1 > out_cap) return 1;
    memcpy(out, canon.c_str(), canon.size() + 1);
    return 0;
  } catch (...) {
    return 1;
  }
}

// Batched canonicalization: NUL-separated input blob of n_rows strings ->
// NUL-separated output blob (unparseable inputs echo back verbatim, the
// reference evaluate.py:27-32 contract). Returns bytes written incl. final
// NUL, or -1 if out_cap is too small. One ctypes crossing per beam list
// instead of one per prediction (retro eval hot path, evaluate.py:67).
int cchem_canonical_smiles_batch(const char* smiles_blob, int n_rows,
                                 char* out, int out_cap) {
  const char* p = smiles_blob;
  int written = 0;
  for (int row = 0; row < n_rows; ++row) {
    std::string canon;
    try {
      canon = canonical_smiles_impl(p);
    } catch (...) {
      canon = p;
    }
    if (written + (int)canon.size() + 1 > out_cap) return -1;
    memcpy(out + written, canon.c_str(), canon.size() + 1);
    written += (int)canon.size() + 1;
    p += strlen(p) + 1;
  }
  return written;
}

}  // extern "C"
