"""The n-species prey/predator chain of the paper's Fig. 4 (Aldinucci et
al., arXiv:1010.2438): s0 reproduces, s_i eats s_{i-1}, the last dies;
all species live at the top level."""

TOP = "⊤"


def generate(n_species, k_reproduce, k_eat, k_die, prey0, pred0, mid0):
    s = [f"{TOP}/s{i}" for i in range(n_species)]
    reactions = [({s[0]: 1}, {s[0]: 2}, k_reproduce)]
    reactions += [({s[i - 1]: 1, s[i]: 1}, {s[i]: 2}, k_eat)
                  for i in range(1, n_species)]
    reactions.append(({s[-1]: 1}, {}, k_die))
    x0 = {s[0]: prey0, s[-1]: pred0}
    x0.update({s[i]: mid0 for i in range(1, n_species - 1)})
    return s, reactions, x0, [(name, [name]) for name in s]
