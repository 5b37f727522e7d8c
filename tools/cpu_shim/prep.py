"""Rewrite a .cu source for the CPU thread shim: each launch k<<<g, b, smem,
s>>>(args) becomes shim_launch(...), shared arrays static or the dynamic buffer."""
import re, sys
src = open(sys.argv[1]).read()
src = re.sub(r'extern __shared__ (\w+) (\w+)\[\];', r'\1* \2 = (\1*)shim_dyn_smem;', src)
src = re.sub(r'__shared__ ', 'static ', src)
out, i = [], 0
while True:
    j = src.find('<<<', i)
    if j < 0:
        out.append(src[i:]); break
    # kernel name: back to the previous whitespace/statement start
    k = j
    depth = 0
    while k > 0:
        ch = src[k - 1]
        if ch == '>': depth += 1
        elif ch == '<': depth -= 1
        elif depth == 0 and not (ch.isalnum() or ch in '_:'):
            break
        k -= 1
    name = src[k:j]
    e = src.index('>>>', j)
    cfg = src[j + 3:e]
    # args
    assert src[e + 3] == '(', src[e:e+20]
    d, p = 0, e + 3
    while True:
        if src[p] == '(': d += 1
        elif src[p] == ')':
            d -= 1
            if d == 0: break
        p += 1
    args = src[e + 4:p]
    parts, dd, cur = [], 0, ''
    for ch in cfg:
        if ch in '([{<': dd += 1
        if ch in ')]}>': dd -= 1
        if ch == ',' and dd == 0: parts.append(cur); cur = ''
        else: cur += ch
    parts.append(cur)
    while len(parts) < 3: parts.append('0')
    out.append(src[i:k])
    out.append(f'shim_launch(dim3({parts[0]}), dim3({parts[1]}), (size_t)({parts[2]}), [&]() {{ {name}({args}); }})')
    i = p + 1
open(sys.argv[2], 'w').write(''.join(out))
