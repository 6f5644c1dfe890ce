// Drawing and image writing on the host, without cv2: the raster
// primitives the JAX package's plots call through cv2 (its drawing.cpp:
// fixed-point coordinates with 16 fractional bits, 8-connected Bresenham
// lines, the anti-aliased line with its filter tables, convex polygon fill,
// thick lines as quads with round caps, the integer circle, ellipse
// polygons) and text as alpha-blended glyph bitmaps, plus a baseline JPEG
// encoder (4:2:0, libjpeg's quality scaling and standard Huffman tables)
// and a PNG encoder over zlib. Images are uint8, row-major, 1 or 3
// channels; a colour gives one byte per channel in the image's order.
// Built by g++ at first use (utils/build.py) and bound by utils/draw.py.
#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

typedef int64_t i64;
struct P {
    i64 x, y;
};
enum { XY_SHIFT = 16, XY_ONE = 1 << XY_SHIFT, LINE_AA = 16 };

struct Img {
    uint8_t* data;
    int h, w, c;
    uint8_t* px(int x, int y) const { return data + ((size_t)y * w + x) * c; }
    void put(int x, int y, const uint8_t* col) const {
        if (x >= 0 && x < w && y >= 0 && y < h) memcpy(px(x, y), col, c);
    }
    void hline(int y, int x1, int x2, const uint8_t* col) const {
        uint8_t* p = px(x1, y);
        for (int x = x1; x <= x2; x++, p += c) memcpy(p, col, c);
    }
};

inline int cv_round(double v) { return (int)std::lrint(v); }

bool clip_line(i64 width, i64 height, P& pt1, P& pt2) {
    if (width <= 0 || height <= 0) return false;
    i64 right = width - 1, bottom = height - 1;
    i64 &x1 = pt1.x, &y1 = pt1.y, &x2 = pt2.x, &y2 = pt2.y;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        i64 a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (i64)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (i64)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (i64)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (i64)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// 8-connected line between integer points, drawn left to right
void line8(const Img& im, P p1, P p2, const uint8_t* col) {
    if ((uint64_t)p1.x >= (uint64_t)im.w || (uint64_t)p2.x >= (uint64_t)im.w ||
        (uint64_t)p1.y >= (uint64_t)im.h || (uint64_t)p2.y >= (uint64_t)im.h) {
        if (!clip_line(im.w, im.h, p1, p2)) return;
    }
    i64 dx = p2.x - p1.x, dy = p2.y - p1.y;
    int sx = 1, sy = 1;
    if (dx < 0) {
        dx = -dx;
        dy = -dy;
        std::swap(p1, p2);
    }
    if (dy < 0) {
        dy = -dy;
        sy = -1;
    }
    bool vert = dy > dx;
    if (vert) {
        std::swap(dx, dy);
        std::swap(sx, sy);
    }
    i64 err = dx - (dy + dy), plus = dx + dx, minus = -(dy + dy);
    i64 x = p1.x, y = p1.y;
    for (i64 i = 0; i <= dx; i++) {
        memcpy(im.px((int)x, (int)y), col, im.c);
        bool m = err < 0;
        err += minus + (m ? plus : 0);
        if (!vert) {
            x += sx;
            if (m) y += sy;
        } else {
            y += sx;
            if (m) x += sy;
        }
    }
}

// 8-connected line between fixed-point points
void line2(const Img& im, P pt1, P pt2, const uint8_t* col) {
    if (!clip_line((i64)im.w << XY_SHIFT, (i64)im.h << XY_SHIFT, pt1, pt2)) return;
    i64 dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
    i64 j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
    i64 i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
    i64 x_step, y_step;
    int ecount;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        if (j) std::swap(pt1, pt2);
        x_step = XY_ONE;
        y_step = (dy << XY_SHIFT) / (ax | 1);
        ecount = (int)((pt2.x - pt1.x) >> XY_SHIFT);
    } else {
        dx = (dx ^ i) - i;
        if (i) std::swap(pt1, pt2);
        x_step = (dx << XY_SHIFT) / (ay | 1);
        y_step = XY_ONE;
        ecount = (int)((pt2.y - pt1.y) >> XY_SHIFT);
    }
    pt1.x += XY_ONE >> 1;
    pt1.y += XY_ONE >> 1;
    im.put((int)((pt2.x + (XY_ONE >> 1)) >> XY_SHIFT), (int)((pt2.y + (XY_ONE >> 1)) >> XY_SHIFT),
           col);
    if (ax > ay) {
        pt1.x >>= XY_SHIFT;
        for (; ecount >= 0; ecount--) {
            im.put((int)pt1.x, (int)(pt1.y >> XY_SHIFT), col);
            pt1.x++;
            pt1.y += y_step;
        }
    } else {
        pt1.y >>= XY_SHIFT;
        for (; ecount >= 0; ecount--) {
            im.put((int)(pt1.x >> XY_SHIFT), (int)pt1.y, col);
            pt1.x += x_step;
            pt1.y++;
        }
    }
}

const int SlopeCorrTable[] = {181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190,
                              192, 194, 196, 198, 201, 203, 206, 209, 211, 214, 218,
                              221, 224, 227, 231, 235, 238, 242, 246, 250, 254};
const int FilterTable[] = {168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249,
                           252, 254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218,
                           210, 202, 194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105,
                           97,  89,  82,  75,  68,  62,  56,  50,  45,  40,  36,  32,  28,
                           25,  22,  19,  16,  14,  12,  11,  9,   8,   7,   5,   5};

inline void blend_aa(const Img& im, int x, int y, const uint8_t* col, int a) {
    uint8_t* t = im.px(x, y);
    for (int k = 0; k < im.c; k++) {
        int v = t[k];
        v += ((col[k] - v) * a + 127) >> 8;
        v += ((col[k] - v) * a + 127) >> 8;
        t[k] = (uint8_t)v;
    }
}

// the anti-aliased line between fixed-point points
void line_aa(const Img& im, P pt1, P pt2, const uint8_t* col) {
    i64 W = im.w, H = im.h;
    if (!clip_line(W << XY_SHIFT, H << XY_SHIFT, pt1, pt2)) return;
    i64 dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
    i64 j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
    i64 i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
    i64 x_step, y_step;
    int ecount, scount = 0, slope;
    int ep_table[9];
    if (ax > ay) {
        dy = (dy ^ j) - j;
        if (j) std::swap(pt1, pt2);
        x_step = XY_ONE;
        y_step = (dy << XY_SHIFT) / (ax | 1);
        pt2.x += XY_ONE;
        ecount = (int)((pt2.x >> XY_SHIFT) - (pt1.x >> XY_SHIFT));
        j = -(pt1.x & (XY_ONE - 1));
        pt1.y += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
        slope = (y_step >> (XY_SHIFT - 5)) & 0x3f;
        slope ^= (y_step < 0 ? 0x3f : 0);
        i = (pt1.x >> (XY_SHIFT - 7)) & 0x78;
        j = (pt2.x >> (XY_SHIFT - 7)) & 0x78;
    } else {
        dx = (dx ^ i) - i;
        if (i) std::swap(pt1, pt2);
        x_step = (dx << XY_SHIFT) / (ay | 1);
        y_step = XY_ONE;
        pt2.y += XY_ONE;
        ecount = (int)((pt2.y >> XY_SHIFT) - (pt1.y >> XY_SHIFT));
        j = -(pt1.y & (XY_ONE - 1));
        pt1.x += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
        slope = (x_step >> (XY_SHIFT - 5)) & 0x3f;
        slope ^= (x_step < 0 ? 0x3f : 0);
        i = (pt1.y >> (XY_SHIFT - 7)) & 0x78;
        j = (pt2.y >> (XY_SHIFT - 7)) & 0x78;
    }
    slope = (slope & 0x20) ? 0x100 : SlopeCorrTable[slope];
    {
        int t0 = slope << 7;
        int t1 = ((0x78 - (int)i) | 4) * slope;
        int t2 = ((int)j | 4) * slope;
        ep_table[0] = 0;
        ep_table[8] = slope;
        ep_table[1] = ep_table[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff;
        ep_table[2] = (t1 >> 8) & 0x1ff;
        ep_table[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff;
        ep_table[5] = ((t1 + t0) >> 8) & 0x1ff;
        ep_table[6] = (t2 >> 8) & 0x1ff;
        ep_table[7] = ((t2 + t0) >> 8) & 0x1ff;
    }
    if (ax > ay) {
        int x = (int)(pt1.x >> XY_SHIFT);
        for (; ecount >= 0; x++, pt1.y += y_step, scount++, ecount--) {
            if ((unsigned)x >= (unsigned)W) continue;
            int y = (int)((pt1.y >> XY_SHIFT) - 1);
            int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                                   (((ecount >= 2) + 1) & (ecount | 2))];
            int a, dist = (pt1.y >> (XY_SHIFT - 5)) & 31;
            a = (ep_corr * FilterTable[dist + 32] >> 8) & 0xff;
            if ((unsigned)y < (unsigned)H) blend_aa(im, x, y, col, a);
            a = (ep_corr * FilterTable[dist] >> 8) & 0xff;
            if ((unsigned)(y + 1) < (unsigned)H) blend_aa(im, x, y + 1, col, a);
            a = (ep_corr * FilterTable[63 - dist] >> 8) & 0xff;
            if ((unsigned)(y + 2) < (unsigned)H) blend_aa(im, x, y + 2, col, a);
        }
    } else {
        int y = (int)(pt1.y >> XY_SHIFT);
        for (; ecount >= 0; y++, pt1.x += x_step, scount++, ecount--) {
            if ((unsigned)y >= (unsigned)H) continue;
            int x = (int)((pt1.x >> XY_SHIFT) - 1);
            int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                                   (((ecount >= 2) + 1) & (ecount | 2))];
            int a, dist = (pt1.x >> (XY_SHIFT - 5)) & 31;
            a = (ep_corr * FilterTable[dist + 32] >> 8) & 0xff;
            if ((unsigned)x < (unsigned)W) blend_aa(im, x, y, col, a);
            a = (ep_corr * FilterTable[dist] >> 8) & 0xff;
            if ((unsigned)(x + 1) < (unsigned)W) blend_aa(im, x + 1, y, col, a);
            a = (ep_corr * FilterTable[63 - dist] >> 8) & 0xff;
            if ((unsigned)(x + 2) < (unsigned)W) blend_aa(im, x + 2, y, col, a);
        }
    }
}

// the edge of a polygon at `shift` fractional bits, as the fill draws it
void edge_line(const Img& im, P p0, P p, const uint8_t* col, int line_type, int shift) {
    if (line_type < LINE_AA) {
        if (shift == 0)
            line8(im, {p0.x >> XY_SHIFT, p0.y >> XY_SHIFT}, {p.x >> XY_SHIFT, p.y >> XY_SHIFT},
                  col);
        else
            line2(im, p0, p, col);
    } else {
        line_aa(im, p0, p, col);
    }
}

void fill_convex_poly(const Img& im, const P* v, int npts, const uint8_t* col, int line_type,
                      int shift) {
    struct {
        int idx, di;
        i64 x, dx;
        int ye;
    } edge[2];
    int delta = 1 << shift >> 1;
    int i, y, imin = 0;
    int edges = npts;
    i64 xmin, xmax, ymin, ymax;
    int delta1, delta2;
    if (line_type < LINE_AA)
        delta1 = delta2 = XY_ONE >> 1;
    else
        delta1 = XY_ONE - 1, delta2 = 0;
    P p0 = v[npts - 1];
    p0.x <<= XY_SHIFT - shift;
    p0.y <<= XY_SHIFT - shift;
    xmin = xmax = v[0].x;
    ymin = ymax = v[0].y;
    for (i = 0; i < npts; i++) {
        P p = v[i];
        if (p.y < ymin) {
            ymin = p.y;
            imin = i;
        }
        ymax = std::max(ymax, p.y);
        xmax = std::max(xmax, p.x);
        xmin = std::min(xmin, p.x);
        p.x <<= XY_SHIFT - shift;
        p.y <<= XY_SHIFT - shift;
        edge_line(im, p0, p, col, line_type, shift);
        p0 = p;
    }
    xmin = (xmin + delta) >> shift;
    xmax = (xmax + delta) >> shift;
    ymin = (ymin + delta) >> shift;
    ymax = (ymax + delta) >> shift;
    if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= im.w || (int)ymin >= im.h)
        return;
    ymax = std::min<i64>(ymax, im.h - 1);
    edge[0].idx = edge[1].idx = imin;
    edge[0].ye = edge[1].ye = y = (int)ymin;
    edge[0].di = 1;
    edge[1].di = npts - 1;
    edge[0].x = edge[1].x = -XY_ONE;
    edge[0].dx = edge[1].dx = 0;
    do {
        if (line_type < LINE_AA || y < (int)ymax || y == (int)ymin) {
            for (i = 0; i < 2; i++) {
                if (y >= edge[i].ye) {
                    int idx0 = edge[i].idx, di = edge[i].di;
                    int idx = idx0 + di;
                    if (idx >= npts) idx -= npts;
                    int ty = 0;
                    for (; edges-- > 0;) {
                        ty = (int)((v[idx].y + delta) >> shift);
                        if (ty > y) {
                            i64 xs = v[idx0].x;
                            i64 xe = v[idx].x;
                            if (shift != XY_SHIFT) {
                                xs <<= XY_SHIFT - shift;
                                xe <<= XY_SHIFT - shift;
                            }
                            edge[i].ye = ty;
                            edge[i].dx = ((xe - xs) * 2 + ((i64)ty - y)) / (2 * ((i64)ty - y));
                            edge[i].x = xs;
                            edge[i].idx = idx;
                            break;
                        }
                        idx0 = idx;
                        idx += di;
                        if (idx >= npts) idx -= npts;
                    }
                }
            }
        }
        if (edges < 0) break;
        if (y >= 0) {
            int left = 0, right = 1;
            if (edge[0].x > edge[1].x) left = 1, right = 0;
            int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
            int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
            if (xx2 >= 0 && xx1 < im.w) {
                if (xx1 < 0) xx1 = 0;
                if (xx2 >= im.w) xx2 = im.w - 1;
                if (xx1 <= xx2) im.hline(y, xx1, xx2, col);
            }
        }
        edge[0].x += edge[0].dx;
        edge[1].x += edge[1].dx;
    } while (++y <= (int)ymax);
}

// cv2's general polygon fill (drawing.cpp's CollectPolyEdges and
// FillEdgeCollection, with 8-connected edges): each contour's
// edges are drawn as lines and collected with their fixed-point slopes,
// then a scanline walks them sorted by (y0, x, dx), filling between the
// pairs of an active list kept in x order by a bubble sort, so a polygon
// that is not convex, or crosses itself, fills by the even-odd rule. An
// edge that leaves the image takes its clipped line's ends for x (its rows
// stay the unclipped ones where the clipped line is flat), and a span's
// left end rounds up: cv2 5.0's arithmetic, found by probing it
struct PolyEdge {
    int y0, y1;
    i64 x, dx;
    PolyEdge* next;
};

void collect_poly_edges(const Img& im, const P* v, int count, std::vector<PolyEdge>& edges,
                        const uint8_t* col, int shift) {
    int delta = (1 << shift) >> 1;
    P pt0 = v[count - 1], pt1;
    pt0.x = pt0.x << (XY_SHIFT - shift);
    pt0.y = (pt0.y + delta) >> shift;
    for (int i = 0; i < count; i++, pt0 = pt1) {
        pt1 = v[i];
        pt1.x = pt1.x << (XY_SHIFT - shift);
        pt1.y = (pt1.y + delta) >> shift;
        P pt0c = pt0, pt1c = pt1;
        P t0 = {(pt0.x + (XY_ONE >> 1)) >> XY_SHIFT, pt0.y};
        P t1 = {(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, pt1.y};
        line8(im, t0, t1, col);
        // the clipped ends give the edge where the line leaves the image
        if ((uint64_t)t0.x >= (uint64_t)im.w || (uint64_t)t1.x >= (uint64_t)im.w ||
            (uint64_t)t0.y >= (uint64_t)im.h || (uint64_t)t1.y >= (uint64_t)im.h) {
            clip_line(im.w, im.h, t0, t1);
            if (t0.y != t1.y) {
                pt0c.y = t0.y;
                pt1c.y = t1.y;
            }
            pt0c.x = t0.x << XY_SHIFT;
            pt1c.x = t1.x << XY_SHIFT;
        }
        if (pt0.y == pt1.y) continue;
        PolyEdge e;
        e.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
        if (pt0.y < pt1.y) {
            e.y0 = (int)pt0.y;
            e.y1 = (int)pt1.y;
            e.x = pt0c.x + (pt0.y - pt0c.y) * e.dx;
        } else {
            e.y0 = (int)pt1.y;
            e.y1 = (int)pt0.y;
            e.x = pt1c.x + (pt1.y - pt1c.y) * e.dx;
        }
        e.next = nullptr;
        edges.push_back(e);
    }
}

void fill_edge_collection(const Img& im, std::vector<PolyEdge>& edges, const uint8_t* col) {
    int total = (int)edges.size();
    if (total < 2) return;
    int y_max = INT32_MIN, y_min = INT32_MAX;
    i64 x_max = -1, x_min = INT64_MAX;
    for (const PolyEdge& e1 : edges) {
        i64 x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
        y_min = std::min(y_min, e1.y0);
        y_max = std::max(y_max, e1.y1);
        x_min = std::min(x_min, std::min(e1.x, x1));
        x_max = std::max(x_max, std::max(e1.x, x1));
    }
    if (y_max < 0 || y_min >= im.h || x_max < 0 || x_min >= ((i64)im.w << XY_SHIFT)) return;
    std::sort(edges.begin(), edges.end(), [](const PolyEdge& a, const PolyEdge& b) {
        return a.y0 - b.y0 ? a.y0 < b.y0 : a.x - b.x ? a.x < b.x : a.dx < b.dx;
    });
    PolyEdge tmp;
    tmp.y0 = INT32_MAX;
    edges.push_back(tmp);  // no element is added after this: pointers stay valid
    int i = 0;
    tmp.next = nullptr;
    PolyEdge* e = &edges[i];
    y_max = std::min(y_max, im.h);
    for (int y = e->y0; y < y_max; y++) {
        PolyEdge *last, *prelast, *keep_prelast;
        int draw = 0;
        bool clipline = y < 0;
        prelast = &tmp;
        last = tmp.next;
        while (last || e->y0 == y) {
            if (last && last->y1 == y) {  // the edge ends at this row
                prelast->next = last->next;
                last = last->next;
                continue;
            }
            keep_prelast = prelast;
            if (last && (e->y0 > y || last->x < e->x)) {
                prelast = last;
                last = last->next;
            } else if (i < total) {  // the next edge starts at this row
                prelast->next = e;
                e->next = last;
                prelast = e;
                e = &edges[++i];
            } else {
                break;
            }
            if (draw) {
                if (!clipline) {
                    int x1, x2;
                    // the left end rounds up, the right end down
                    if (keep_prelast->x > prelast->x) {
                        x1 = (int)((prelast->x + XY_ONE - 1) >> XY_SHIFT);
                        x2 = (int)(keep_prelast->x >> XY_SHIFT);
                    } else {
                        x1 = (int)((keep_prelast->x + XY_ONE - 1) >> XY_SHIFT);
                        x2 = (int)(prelast->x >> XY_SHIFT);
                    }
                    if (x1 < im.w && x2 >= 0) {
                        if (x1 < 0) x1 = 0;
                        if (x2 >= im.w) x2 = im.w - 1;
                        if (x1 <= x2) im.hline(y, x1, x2, col);
                    }
                }
                keep_prelast->x += keep_prelast->dx;
                prelast->x += prelast->dx;
            }
            draw ^= 1;
        }
        // keep the active edges in x order (bubble sort)
        keep_prelast = nullptr;
        do {
            prelast = &tmp;
            last = tmp.next;
            PolyEdge* last_exchange = nullptr;
            while (last != keep_prelast && last->next != nullptr) {
                PolyEdge* te = last->next;
                if (last->x > te->x) {
                    prelast->next = te;
                    last->next = te->next;
                    te->next = last;
                    prelast = te;
                    last_exchange = prelast;
                } else {
                    prelast = last;
                    last = te;
                }
            }
            if (last_exchange == nullptr) break;
            keep_prelast = last_exchange;
        } while (keep_prelast != tmp.next && keep_prelast != &tmp);
    }
}


// the integer circle (outline, or filled with `fill`)
void circle_int(const Img& im, P center, int radius, const uint8_t* col, bool fill) {
    int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
    int cx = (int)center.x, cy = (int)center.y;
    int W = im.w, H = im.h;
    bool inside = cx >= radius && cx < W - radius && cy >= radius && cy < H - radius;
    while (dx >= dy) {
        int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
        int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
        if (inside) {
            if (!fill) {
                im.put(x11, y11, col);
                im.put(x11, y12, col);
                im.put(x12, y11, col);
                im.put(x12, y12, col);
                im.put(x21, y21, col);
                im.put(x21, y22, col);
                im.put(x22, y21, col);
                im.put(x22, y22, col);
            } else {
                im.hline(y11, x11, x12, col);
                im.hline(y12, x11, x12, col);
                im.hline(y21, x21, x22, col);
                im.hline(y22, x21, x22, col);
            }
        } else if (x11 < W && x12 >= 0 && y21 < H && y22 >= 0) {
            if (fill) {
                x11 = std::max(x11, 0);
                x12 = std::min(x12, W - 1);
            }
            if ((unsigned)y11 < (unsigned)H) {
                if (!fill) {
                    if (x11 >= 0) im.put(x11, y11, col);
                    if (x12 < W) im.put(x12, y11, col);
                } else {
                    im.hline(y11, x11, x12, col);
                }
            }
            if ((unsigned)y12 < (unsigned)H) {
                if (!fill) {
                    if (x11 >= 0) im.put(x11, y12, col);
                    if (x12 < W) im.put(x12, y12, col);
                } else {
                    im.hline(y12, x11, x12, col);
                }
            }
            if (x21 < W && x22 >= 0) {
                if (fill) {
                    x21 = std::max(x21, 0);
                    x22 = std::min(x22, W - 1);
                }
                if ((unsigned)y21 < (unsigned)H) {
                    if (!fill) {
                        if (x21 >= 0) im.put(x21, y21, col);
                        if (x22 < W) im.put(x22, y21, col);
                    } else {
                        im.hline(y21, x21, x22, col);
                    }
                }
                if ((unsigned)y22 < (unsigned)H) {
                    if (!fill) {
                        if (x21 >= 0) im.put(x21, y22, col);
                        if (x22 < W) im.put(x22, y22, col);
                    } else {
                        im.hline(y22, x21, x22, col);
                    }
                }
            }
        }
        dy++;
        err += plus;
        plus += 2;
        int mask = (err <= 0) - 1;
        err -= minus & mask;
        dx += mask;
        minus -= mask & 2;
    }
}

float sin_table(int deg) {
    // cv2's table: sin at each degree, 7 decimals, as float
    double v = std::sin(deg * M_PI / 180.0);
    return (float)(std::round(v * 1e7) / 1e7);
}

void ellipse2poly(double cx, double cy, double aw, double ah, int angle, int arc_start,
                  int arc_end, int delta, std::vector<double>& pts) {
    while (angle < 0) angle += 360;
    while (angle > 360) angle -= 360;
    if (arc_start > arc_end) std::swap(arc_start, arc_end);
    while (arc_start < 0) {
        arc_start += 360;
        arc_end += 360;
    }
    while (arc_end > 360) {
        arc_end -= 360;
        arc_start -= 360;
    }
    if (arc_end - arc_start > 360) {
        arc_start = 0;
        arc_end = 360;
    }
    float alpha = sin_table(450 - angle), beta = sin_table(angle);
    pts.clear();
    for (int i = arc_start; i < arc_end + delta; i += delta) {
        int a = i;
        if (a > arc_end) a = arc_end;
        if (a < 0) a += 360;
        double x = aw * sin_table(450 - a), y = ah * sin_table(a);
        pts.push_back(cx + x * alpha - y * beta);
        pts.push_back(cy + x * beta + y * alpha);
    }
    if (pts.size() == 2) {
        pts.assign({cx, cy, cx, cy});
    }
}

void poly_line(const Img& im, const P* v, int count, bool closed, const uint8_t* col,
               int thickness, int line_type, int shift);

void ellipse_ex(const Img& im, P center, P axes, int angle, int arc_start, int arc_end,
                const uint8_t* col, int thickness, int line_type) {
    axes.x = std::llabs(axes.x);
    axes.y = std::llabs(axes.y);
    int delta = (int)((std::max(axes.x, axes.y) + (XY_ONE >> 1)) >> XY_SHIFT);
    delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
    std::vector<double> d;
    ellipse2poly((double)center.x, (double)center.y, (double)axes.x, (double)axes.y, angle,
                 arc_start, arc_end, delta, d);
    std::vector<P> v;
    P prev = {(i64)0xFFFFFFFFFFFFFFFFLL, (i64)0xFFFFFFFFFFFFFFFFLL};
    for (size_t k = 0; k + 1 < d.size(); k += 2) {
        P pt;
        pt.x = (i64)cv_round(d[k] / XY_ONE) << XY_SHIFT;
        pt.y = (i64)cv_round(d[k + 1] / XY_ONE) << XY_SHIFT;
        pt.x += cv_round(d[k] - pt.x);
        pt.y += cv_round(d[k + 1] - pt.y);
        if (pt.x != prev.x || pt.y != prev.y) {
            v.push_back(pt);
            prev = pt;
        }
    }
    if (v.size() == 1) v.assign(2, center);
    if (thickness >= 0)
        poly_line(im, v.data(), (int)v.size(), false, col, thickness, line_type, XY_SHIFT);
    else if (arc_end - arc_start >= 360)
        fill_convex_poly(im, v.data(), (int)v.size(), col, line_type, XY_SHIFT);
}

void thick_line(const Img& im, P p0, P p1, const uint8_t* col, int thickness, int line_type,
                int flags, int shift) {
    const double INV_XY_ONE = 1. / XY_ONE;
    p0.x <<= XY_SHIFT - shift;
    p0.y <<= XY_SHIFT - shift;
    p1.x <<= XY_SHIFT - shift;
    p1.y <<= XY_SHIFT - shift;
    if (thickness <= 1) {
        if (line_type < LINE_AA) {
            if (line_type == 1 || line_type == 4 || shift == 0) {
                p0.x = (p0.x + (XY_ONE >> 1)) >> XY_SHIFT;
                p0.y = (p0.y + (XY_ONE >> 1)) >> XY_SHIFT;
                p1.x = (p1.x + (XY_ONE >> 1)) >> XY_SHIFT;
                p1.y = (p1.y + (XY_ONE >> 1)) >> XY_SHIFT;
                line8(im, p0, p1, col);
            } else {
                line2(im, p0, p1, col);
            }
        } else {
            line_aa(im, p0, p1, col);
        }
        return;
    }
    P pt[4], dp = {0, 0};
    double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
    double r = dx * dx + dy * dy;
    int odd = thickness & 1;
    thickness <<= XY_SHIFT - 1;
    if (std::fabs(r) > 2.220446049250313e-16) {
        r = (thickness + odd * XY_ONE * 0.5) / std::sqrt(r);
        dp.x = cv_round(dy * r);
        dp.y = cv_round(dx * r);
        pt[0] = {p0.x + dp.x, p0.y + dp.y};
        pt[1] = {p0.x - dp.x, p0.y - dp.y};
        pt[2] = {p1.x - dp.x, p1.y - dp.y};
        pt[3] = {p1.x + dp.x, p1.y + dp.y};
        fill_convex_poly(im, pt, 4, col, line_type, XY_SHIFT);
    }
    for (int i = 0; i < 2; i++) {
        if (flags & (i + 1)) {
            if (line_type < LINE_AA) {
                P center = {(p0.x + (XY_ONE >> 1)) >> XY_SHIFT, (p0.y + (XY_ONE >> 1)) >> XY_SHIFT};
                circle_int(im, center, (thickness + (XY_ONE >> 1)) >> XY_SHIFT, col, true);
            } else {
                ellipse_ex(im, p0, {thickness, thickness}, 0, 0, 360, col, -1, line_type);
            }
        }
        p0 = p1;
    }
}

void poly_line(const Img& im, const P* v, int count, bool closed, const uint8_t* col,
               int thickness, int line_type, int shift) {
    if (!v || count <= 0) return;
    int i = closed ? count - 1 : 0;
    int flags = 2 + !closed;
    P p0 = v[i];
    for (i = !closed; i < count; i++) {
        P p = v[i];
        thick_line(im, p0, p, col, thickness, line_type, flags, shift);
        p0 = p;
        flags = 2;
    }
}

// ---------------------------------------------------------------- JPEG
const int ZIGZAG[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const int STD_LUMA_Q[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,
                            58, 60, 55, 14, 13, 16, 24,  40,  57,  69,  56, 14, 17,
                            22, 29, 51, 87, 80, 62, 18,  22,  37,  56,  68, 109, 103,
                            77, 24, 35, 55, 64, 81, 104, 113, 92,  49,  64, 78, 87,
                            103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int STD_CHROMA_Q[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const uint8_t DC_LUMA_BITS[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t DC_CHROMA_BITS[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t AC_LUMA_BITS[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t AC_LUMA_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t AC_CHROMA_BITS[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t AC_CHROMA_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Huff {
    uint16_t code[256];
    uint8_t size[256];
    Huff(const uint8_t* bits, const uint8_t* vals) {
        memset(size, 0, sizeof size);
        int k = 0;
        uint16_t c = 0;
        for (int l = 1; l <= 16; l++) {
            for (int n = 0; n < bits[l - 1]; n++, k++) {
                code[vals[k]] = c++;
                size[vals[k]] = (uint8_t)l;
            }
            c <<= 1;
        }
    }
};

struct BitWriter {
    std::vector<uint8_t>& out;
    uint32_t acc = 0;
    int n = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
    void put(uint32_t bits, int len) {
        acc = (acc << len) | (bits & ((1u << len) - 1));
        n += len;
        while (n >= 8) {
            uint8_t b = (uint8_t)(acc >> (n - 8));
            out.push_back(b);
            if (b == 0xFF) out.push_back(0);
            n -= 8;
        }
        acc &= (1u << n) - 1;
    }
    void flush() {
        if (n > 0) put(0x7F, 8 - n);
    }
};

void put16(std::vector<uint8_t>& o, int v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}

// libjpeg's float AAN forward DCT (jfdctflt.c) in place on a level-shifted
// 8x8 block; its outputs carry the scale undone by `aan_divisors`
void fdct_aan(float* d) {
    for (int pass = 0; pass < 2; pass++) {
        const int step = pass ? 8 : 1, next = pass ? 1 : 8;
        for (int k = 0; k < 8; k++) {
            float* p = d + k * next;
            float t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
            float t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
            float t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
            float t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
            float t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
            p[0] = t10 + t11;
            p[4 * step] = t10 - t11;
            float z1 = (t12 + t13) * 0.707106781f;
            p[2 * step] = t13 + z1;
            p[6 * step] = t13 - z1;
            t10 = t4 + t5;
            t11 = t5 + t6;
            t12 = t6 + t7;
            float z5 = (t10 - t12) * 0.382683433f;
            float z2 = 0.541196100f * t10 + z5;
            float z4 = 1.306562965f * t12 + z5;
            float z3 = t11 * 0.707106781f;
            float z11 = t7 + z3, z13 = t7 - z3;
            p[5 * step] = z13 + z2;
            p[3 * step] = z13 - z2;
            p[step] = z11 + z4;
            p[7 * step] = z11 - z4;
        }
    }
}

// 1 / (q * 8 * aan(row) * aan(col)), libjpeg's float divisors, natural order
void aan_divisors(const int* q, float* div) {
    static const double aan[8] = {1.0, 1.387039845, 1.306562965, 1.175875602,
                                  1.0, 0.785694958, 0.541196100, 0.275899379};
    for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++) div[r * 8 + c] = (float)(1.0 / (q[r * 8 + c] * aan[r] * aan[c] * 8.0));
}

void encode_block(BitWriter& bw, float* blk, const float* div, int& prev_dc, const Huff& dc,
                  const Huff& ac) {
    fdct_aan(blk);
    int zz[64];
    for (int k = 0; k < 64; k++) {
        float v = blk[ZIGZAG[k]] * div[ZIGZAG[k]];
        zz[k] = v < 0 ? -(int)(-v + 0.5f) : (int)(v + 0.5f);  // half away from zero
    }
    auto category = [](int v) {
        int a = v < 0 ? -v : v, n = 0;
        while (a) {
            n++;
            a >>= 1;
        }
        return n;
    };
    int diff = zz[0] - prev_dc;
    prev_dc = zz[0];
    int s = category(diff);
    bw.put(dc.code[s], dc.size[s]);
    if (s) bw.put(diff < 0 ? diff - 1 : diff, s);
    int run = 0;
    for (int k = 1; k < 64; k++) {
        if (zz[k] == 0) {
            run++;
            continue;
        }
        while (run > 15) {
            bw.put(ac.code[0xF0], ac.size[0xF0]);
            run -= 16;
        }
        s = category(zz[k]);
        int sym = (run << 4) | s;
        bw.put(ac.code[sym], ac.size[sym]);
        bw.put(zz[k] < 0 ? zz[k] - 1 : zz[k], s);
        run = 0;
    }
    if (run) bw.put(ac.code[0], ac.size[0]);
}

void quant_table(const int* base, int quality, int* out) {
    quality = std::min(std::max(quality, 1), 100);
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; i++) {
        long t = ((long)base[i] * scale + 50) / 100;
        out[i] = (int)std::min(std::max(t, 1L), 255L);
    }
}

void dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int i = 0; i < 16; i++) n += bits[i];
    o.push_back(0xFF);
    o.push_back(0xC4);
    put16(o, 2 + 1 + 16 + n);
    o.push_back((uint8_t)cls_id);
    o.insert(o.end(), bits, bits + 16);
    o.insert(o.end(), vals, vals + n);
}

std::vector<uint8_t> encode_jpeg(const uint8_t* img, int h, int w, int c, int quality) {
    int qy[64], qc[64];
    quant_table(STD_LUMA_Q, quality, qy);
    quant_table(STD_CHROMA_Q, quality, qc);
    float dy[64], dc[64];
    aan_divisors(qy, dy);
    aan_divisors(qc, dc);
    const bool color = c == 3;
    const int ncomp = color ? 3 : 1;
    const int mcu = color ? 16 : 8;
    const int pw = (w + mcu - 1) / mcu * mcu, ph = (h + mcu - 1) / mcu * mcu;
    // the planes at the padded size, edges replicated; Y, then Cb, Cr
    std::vector<uint8_t> Y((size_t)pw * ph), Cb, Cr;
    if (color) {
        Cb.resize((size_t)pw * ph);
        Cr.resize((size_t)pw * ph);
    }
    const int32_t ONE_HALF = 1 << 15;
    auto FIX = [](double x) { return (int32_t)(x * 65536 + 0.5); };
    const int32_t r_y = FIX(0.29900), g_y = FIX(0.58700), b_y = FIX(0.11400);
    const int32_t r_cb = -FIX(0.16874), g_cb = -FIX(0.33126), b_cb = FIX(0.5);
    const int32_t r_cr = FIX(0.5), g_cr = -FIX(0.41869), b_cr = -FIX(0.08131);
    const int32_t off = (128 << 16) + ONE_HALF - 1;
    for (int y = 0; y < ph; y++) {
        const uint8_t* row = img + (size_t)std::min(y, h - 1) * w * c;
        for (int x = 0; x < pw; x++) {
            const uint8_t* p = row + (size_t)std::min(x, w - 1) * c;
            size_t o = (size_t)y * pw + x;
            if (!color) {
                Y[o] = p[0];
                continue;
            }
            int b = p[0], g = p[1], r = p[2];  // BGR in
            Y[o] = (uint8_t)((r_y * r + g_y * g + b_y * b + ONE_HALF) >> 16);
            Cb[o] = (uint8_t)((r_cb * r + g_cb * g + b_cb * b + off) >> 16);
            Cr[o] = (uint8_t)((r_cr * r + g_cr * g + b_cr * b + off) >> 16);
        }
    }
    // 2x2 chroma averages with libjpeg's alternating bias
    const int cw = pw / 2, ch = ph / 2;
    std::vector<uint8_t> Cb2, Cr2;
    if (color) {
        Cb2.resize((size_t)cw * ch);
        Cr2.resize((size_t)cw * ch);
        for (int y = 0; y < ch; y++)
            for (int x = 0; x < cw; x++) {
                int bias = (x & 1) ? 2 : 1;
                size_t a = (size_t)(2 * y) * pw + 2 * x, b = a + pw;
                Cb2[(size_t)y * cw + x] = (uint8_t)((Cb[a] + Cb[a + 1] + Cb[b] + Cb[b + 1] + bias) >> 2);
                Cr2[(size_t)y * cw + x] = (uint8_t)((Cr[a] + Cr[a + 1] + Cr[b] + Cr[b + 1] + bias) >> 2);
            }
    }
    std::vector<uint8_t> o;
    o.reserve((size_t)w * h / 2 + 1024);
    o.insert(o.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                       0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00});
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 2 + 65 * (color ? 2 : 1));
    o.push_back(0);
    for (int k = 0; k < 64; k++) o.push_back((uint8_t)qy[ZIGZAG[k]]);
    if (color) {
        o.push_back(1);
        for (int k = 0; k < 64; k++) o.push_back((uint8_t)qc[ZIGZAG[k]]);
    }
    o.push_back(0xFF);
    o.push_back(0xC0);
    put16(o, 8 + 3 * ncomp);
    o.push_back(8);
    put16(o, h);
    put16(o, w);
    o.push_back((uint8_t)ncomp);
    if (color) {
        o.insert(o.end(), {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
    } else {
        o.insert(o.end(), {1, 0x11, 0});
    }
    dht(o, 0x00, DC_LUMA_BITS, DC_VALS);
    dht(o, 0x10, AC_LUMA_BITS, AC_LUMA_VALS);
    if (color) {
        dht(o, 0x01, DC_CHROMA_BITS, DC_VALS);
        dht(o, 0x11, AC_CHROMA_BITS, AC_CHROMA_VALS);
    }
    o.push_back(0xFF);
    o.push_back(0xDA);
    put16(o, 6 + 2 * ncomp);
    o.push_back((uint8_t)ncomp);
    if (color)
        o.insert(o.end(), {1, 0x00, 2, 0x11, 3, 0x11});
    else
        o.insert(o.end(), {1, 0x00});
    o.insert(o.end(), {0, 63, 0});
    static const Huff dcy(DC_LUMA_BITS, DC_VALS), acy(AC_LUMA_BITS, AC_LUMA_VALS);
    static const Huff dcc(DC_CHROMA_BITS, DC_VALS), acc(AC_CHROMA_BITS, AC_CHROMA_VALS);
    BitWriter bw(o);
    int pdy = 0, pdb = 0, pdr = 0;
    float blk[64];
    auto load = [&](const std::vector<uint8_t>& plane, int stride, int x0, int y0) {
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                blk[y * 8 + x] = (float)plane[(size_t)(y0 + y) * stride + x0 + x] - 128.f;
    };
    for (int my = 0; my < ph; my += mcu)
        for (int mx = 0; mx < pw; mx += mcu) {
            if (!color) {
                load(Y, pw, mx, my);
                encode_block(bw, blk, dy, pdy, dcy, acy);
                continue;
            }
            for (int by = 0; by < 16; by += 8)
                for (int bx = 0; bx < 16; bx += 8) {
                    load(Y, pw, mx + bx, my + by);
                    encode_block(bw, blk, dy, pdy, dcy, acy);
                }
            load(Cb2, cw, mx / 2, my / 2);
            encode_block(bw, blk, dc, pdb, dcc, acc);
            load(Cr2, cw, mx / 2, my / 2);
            encode_block(bw, blk, dc, pdr, dcc, acc);
        }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
    return o;
}

// ---------------------------------------------------------------- PNG
void png_chunk(std::vector<uint8_t>& o, const char* type, const uint8_t* data, size_t n) {
    uint8_t len[4] = {(uint8_t)(n >> 24), (uint8_t)(n >> 16), (uint8_t)(n >> 8), (uint8_t)n};
    o.insert(o.end(), len, len + 4);
    size_t start = o.size();
    o.insert(o.end(), type, type + 4);
    if (n) o.insert(o.end(), data, data + n);
    uLong crc = crc32(0L, o.data() + start, (uInt)(o.size() - start));
    uint8_t cb[4] = {(uint8_t)(crc >> 24), (uint8_t)(crc >> 16), (uint8_t)(crc >> 8), (uint8_t)crc};
    o.insert(o.end(), cb, cb + 4);
}

bool encode_png(const uint8_t* img, int h, int w, int c, int level, std::vector<uint8_t>& o) {
    // rows with PNG's Sub filter; BGR in, RGB out
    size_t rowb = (size_t)w * c;
    std::vector<uint8_t> raw((rowb + 1) * h);
    for (int y = 0; y < h; y++) {
        uint8_t* d = raw.data() + (rowb + 1) * y;
        const uint8_t* s = img + rowb * y;
        d[0] = 1;
        for (int x = 0; x < w; x++)
            for (int k = 0; k < c; k++) {
                int sk = c == 3 ? 2 - k : k;
                int cur = s[(size_t)x * c + sk];
                int left = x ? s[(size_t)(x - 1) * c + sk] : 0;
                d[1 + (size_t)x * c + k] = (uint8_t)(cur - left);
            }
    }
    uLongf zn = compressBound((uLong)raw.size());
    std::vector<uint8_t> z(zn);
    if (compress2(z.data(), &zn, raw.data(), (uLong)raw.size(), level) != Z_OK) return false;
    const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
    o.assign(sig, sig + 8);
    uint8_t ihdr[13] = {(uint8_t)(w >> 24), (uint8_t)(w >> 16), (uint8_t)(w >> 8), (uint8_t)w,
                        (uint8_t)(h >> 24), (uint8_t)(h >> 16), (uint8_t)(h >> 8), (uint8_t)h,
                        8, (uint8_t)(c == 3 ? 2 : 0), 0, 0, 0};
    png_chunk(o, "IHDR", ihdr, 13);
    png_chunk(o, "IDAT", z.data(), zn);
    png_chunk(o, "IEND", nullptr, 0);
    return true;
}

uint8_t* to_malloc(const std::vector<uint8_t>& v, int64_t* n) {
    uint8_t* p = (uint8_t*)malloc(v.size());
    if (p) memcpy(p, v.data(), v.size());
    *n = p ? (int64_t)v.size() : -1;
    return p;
}

}  // namespace

extern "C" {

// cv2.line: both ends capped
void mgdt_line(uint8_t* data, int h, int w, int c, int64_t x1, int64_t y1, int64_t x2,
               int64_t y2, const uint8_t* col, int thickness, int line_type, int shift) {
    Img im{data, h, w, c};
    thick_line(im, {x1, y1}, {x2, y2}, col, thickness, line_type, 3, shift);
}

// cv2.rectangle: an outline of `thickness`, or filled when it is negative
void mgdt_rectangle(uint8_t* data, int h, int w, int c, int64_t x1, int64_t y1, int64_t x2,
                    int64_t y2, const uint8_t* col, int thickness, int line_type, int shift) {
    Img im{data, h, w, c};
    P pt[4] = {{x1, y1}, {x2, y1}, {x2, y2}, {x1, y2}};
    if (thickness >= 0)
        poly_line(im, pt, 4, true, col, thickness, line_type, shift);
    else
        fill_convex_poly(im, pt, 4, col, line_type, shift);
}

// cv2.circle
void mgdt_circle(uint8_t* data, int h, int w, int c, int64_t cx, int64_t cy, int64_t radius,
                 const uint8_t* col, int thickness, int line_type, int shift) {
    Img im{data, h, w, c};
    if (thickness > 1 || line_type != 8 || shift > 0) {
        P center = {cx << (XY_SHIFT - shift), cy << (XY_SHIFT - shift)};
        i64 r = radius << (XY_SHIFT - shift);
        ellipse_ex(im, center, {r, r}, 0, 0, 360, col, thickness, line_type);
    } else {
        circle_int(im, {cx, cy}, (int)radius, col, thickness < 0);
    }
}

// cv2.fillConvexPoly over n (x, y) points
void mgdt_fill_convex_poly(uint8_t* data, int h, int w, int c, const int64_t* pts, int n,
                           const uint8_t* col, int line_type, int shift) {
    Img im{data, h, w, c};
    std::vector<P> v(n);
    for (int i = 0; i < n; i++) v[i] = {pts[2 * i], pts[2 * i + 1]};
    fill_convex_poly(im, v.data(), n, col, line_type, shift);
}

// cv2.fillPoly over contours: counts[k] points each, (x, y) in order
void mgdt_fill_poly(uint8_t* data, int h, int w, int c, const int64_t* pts, const int32_t* counts,
                    int ncontours, const uint8_t* col, int shift) {
    Img im{data, h, w, c};
    std::vector<PolyEdge> edges;
    const P* v = reinterpret_cast<const P*>(pts);
    for (int k = 0; k < ncontours; v += counts[k], k++)
        if (counts[k] > 0) collect_poly_edges(im, v, counts[k], edges, col, shift);
    fill_edge_collection(im, edges, col);
}

// cv2.polylines over n (x, y) points
void mgdt_polylines(uint8_t* data, int h, int w, int c, const int64_t* pts, int n, int closed,
                    const uint8_t* col, int thickness, int line_type, int shift) {
    Img im{data, h, w, c};
    std::vector<P> v(n);
    for (int i = 0; i < n; i++) v[i] = {pts[2 * i], pts[2 * i + 1]};
    poly_line(im, v.data(), n, closed != 0, col, thickness, line_type, shift);
}

// a string of glyphs: each glyph's alpha blended at the pen, which moves
// by its advance; glyphs rows [offset, w, h, dx, dy, advance, descent] by
// code - 32
void mgdt_put_text(uint8_t* data, int h, int w, int c, const int32_t* codes, int n, int ox,
                   int oy, const uint8_t* alpha, const int32_t* glyphs, const uint8_t* col) {
    Img im{data, h, w, c};
    i64 pen = ox;
    for (int i = 0; i < n; i++) {
        const int32_t* g = glyphs + 7 * (codes[i] - 32);
        const uint8_t* a = alpha + g[0];
        for (int y = 0; y < g[2]; y++) {
            i64 yy = (i64)oy + g[4] + y;
            if (yy < 0 || yy >= h) continue;
            for (int x = 0; x < g[1]; x++) {
                i64 xx = pen + g[3] + x;
                int av = a[y * g[1] + x];
                if (av == 0 || xx < 0 || xx >= w) continue;
                uint8_t* p = im.px((int)xx, (int)yy);
                for (int k = 0; k < c; k++) p[k] = (uint8_t)((p[k] * (255 - av) + col[k] * av + 127) / 255);
            }
        }
        pen += g[5];
    }
}

// encoded bytes in a malloc'd buffer (*n its size, -1 on failure); free
// with mgdt_free
uint8_t* mgdt_encode_jpeg(const uint8_t* img, int h, int w, int c, int quality, int64_t* n) {
    return to_malloc(encode_jpeg(img, h, w, c, quality), n);
}

uint8_t* mgdt_encode_png(const uint8_t* img, int h, int w, int c, int level, int64_t* n) {
    std::vector<uint8_t> o;
    if (!encode_png(img, h, w, c, level, o)) {
        *n = -1;
        return nullptr;
    }
    return to_malloc(o, n);
}

void mgdt_free(uint8_t* p) { free(p); }

}  // extern "C"
