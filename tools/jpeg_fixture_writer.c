/* Writes one JPEG file with libjpeg from raw interleaved 8-bit samples,
 * with the options PIL does not offer: arithmetic coding, any progressive
 * scan script, restart intervals in progressive files, YCCK and CMYK,
 * components of unknown colour, sampling factors and DAC conditioning.
 * tools/make_image_fixtures.py builds and runs it:
 *
 *   jpeg_fixture_writer IN.raw OUT.jpg WIDTH HEIGHT COMPONENTS [KEY=VALUE]...
 *
 * keys: quality=Q, arith=0|1, progressive=0|1 (libjpeg's default
 * script), scans="c,c:ss:se:ah:al;..." (a script: component indices, then
 * the band and the successive-approximation bits), restart=MCUS,
 * restart_rows=ROWS, sampling="HxV,HxV,...", space=ycbcr|rgb|gray|cmyk|
 * ycck|unknown, dac="L,U,K" (arithmetic conditioning of table 0),
 * optimize=0|1.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static jpeg_scan_info scans[64];

static int parse_scans(const char *s) {
  int n = 0;
  while (*s && n < 64) {
    jpeg_scan_info *si = &scans[n];
    si->comps_in_scan = 0;
    for (;;) {
      si->component_index[si->comps_in_scan++] = (int)strtol(s, (char **)&s, 10);
      if (*s != ',') break;
      s++;
    }
    if (sscanf(s, ":%d:%d:%d:%d", &si->Ss, &si->Se, &si->Ah, &si->Al) != 4)
      return -1;
    n++;
    s = strchr(s, ';');
    if (!s) break;
    s++;
  }
  return n;
}

int main(int argc, char **argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s IN.raw OUT.jpg W H C [key=value]...\n",
            argv[0]);
    return 2;
  }
  int w = atoi(argv[3]), h = atoi(argv[4]), c = atoi(argv[5]);
  size_t n = (size_t)w * h * c;
  unsigned char *px = malloc(n);
  FILE *f = fopen(argv[1], "rb");
  if (!f || fread(px, 1, n, f) != n) {
    fprintf(stderr, "cannot read %zu bytes of %s\n", n, argv[1]);
    return 1;
  }
  fclose(f);

  struct jpeg_compress_struct ci;
  struct jpeg_error_mgr err;
  ci.err = jpeg_std_error(&err);
  jpeg_create_compress(&ci);
  FILE *out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&ci, out);
  ci.image_width = w;
  ci.image_height = h;
  ci.input_components = c;
  const char *space = "";
  for (int i = 6; i < argc; i++)
    if (!strncmp(argv[i], "space=", 6)) space = argv[i] + 6;
  ci.in_color_space = c == 1 ? JCS_GRAYSCALE : c == 3 ? JCS_RGB
                      : c == 4 ? JCS_CMYK : JCS_UNKNOWN;
  if (!strcmp(space, "unknown")) ci.in_color_space = JCS_UNKNOWN;
  jpeg_set_defaults(&ci);
  if (!strcmp(space, "rgb")) jpeg_set_colorspace(&ci, JCS_RGB);
  if (!strcmp(space, "ycck")) jpeg_set_colorspace(&ci, JCS_YCCK);
  if (!strcmp(space, "cmyk")) jpeg_set_colorspace(&ci, JCS_CMYK);
  int quality = 85, nscans = 0;
  for (int i = 6; i < argc; i++) {
    char *kv = argv[i], *v = strchr(kv, '=');
    if (!v) continue;
    v++;
    if (!strncmp(kv, "quality=", 8)) quality = atoi(v);
    else if (!strncmp(kv, "arith=", 6)) ci.arith_code = atoi(v);
    else if (!strncmp(kv, "optimize=", 9)) ci.optimize_coding = atoi(v);
    else if (!strncmp(kv, "restart=", 8)) ci.restart_interval = atoi(v);
    else if (!strncmp(kv, "restart_rows=", 13)) ci.restart_in_rows = atoi(v);
    else if (!strncmp(kv, "progressive=", 12)) {
      if (atoi(v)) jpeg_simple_progression(&ci);
    } else if (!strncmp(kv, "scans=", 6)) {
      nscans = parse_scans(v);
      if (nscans <= 0) {
        fprintf(stderr, "bad scan script %s\n", v);
        return 2;
      }
    } else if (!strncmp(kv, "sampling=", 9)) {
      for (int k = 0; k < ci.num_components && *v; k++) {
        ci.comp_info[k].h_samp_factor = (int)strtol(v, &v, 10);
        if (*v == 'x') v++;
        ci.comp_info[k].v_samp_factor = (int)strtol(v, &v, 10);
        if (*v == ',') v++;
      }
    } else if (!strncmp(kv, "dac=", 4)) {
      int L, U, K;
      if (sscanf(v, "%d,%d,%d", &L, &U, &K) != 3) return 2;
      ci.arith_dc_L[0] = L;
      ci.arith_dc_U[0] = U;
      ci.arith_ac_K[0] = K;
    }
  }
  jpeg_set_quality(&ci, quality, TRUE);
  if (nscans) {
    ci.scan_info = scans;
    ci.num_scans = nscans;
  }
  jpeg_start_compress(&ci, TRUE);
  while (ci.next_scanline < ci.image_height) {
    JSAMPROW row = px + (size_t)ci.next_scanline * w * c;
    jpeg_write_scanlines(&ci, &row, 1);
  }
  jpeg_finish_compress(&ci);
  jpeg_destroy_compress(&ci);
  fclose(out);
  free(px);
  return 0;
}
